"""Model configurations (the paper's spiking VGG9 in this slice)."""
