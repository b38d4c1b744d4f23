"""Training data: the synthetic particle-image generator, the on-device augmentation, the datasets and the loaders."""
