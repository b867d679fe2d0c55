"""Data: splits, static-shape batch packing and the DataModule."""
