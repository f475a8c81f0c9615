"""SD-family networks in torch.nn: UNet, VAE decoder, CLIP text encoders."""
