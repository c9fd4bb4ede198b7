"""Algorithms written against the port's DeltaAlgorithm contract."""
