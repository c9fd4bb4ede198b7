"""LM serving: prefill, greedy decode steps, generation."""
