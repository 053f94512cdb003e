"""models — RandLA-Net eval forward and the predict step."""
