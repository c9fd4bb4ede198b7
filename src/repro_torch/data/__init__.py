"""Datasets: synthetic power-law graphs shaped like the paper's."""
