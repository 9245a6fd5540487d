"""Partition rules: logical axis names -> mesh axes -> per-leaf shard
shapes, over a mesh given as a dict of axis sizes."""
