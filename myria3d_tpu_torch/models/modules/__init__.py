"""Neural-net modules (RandLA-Net)."""
