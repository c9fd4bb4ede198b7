"""Datasets: synthetic power-law graphs shaped like the paper's, k-means
point sets, and the synthetic LM token stream."""
