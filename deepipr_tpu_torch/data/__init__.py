"""Data helpers: normalize, synthetic data and the train-time augmentation."""
