"""DRED: deep redundancy coding (RDO-VAE latents carried beside packets)."""
