"""Model zoo of the port: ``torch.nn`` modules beside the reference's
pytree parameters and pure apply functions."""
