"""Dense LM models: layers, grouped-query attention, the transformer."""
