"""Multi-card scale-out over a particle-sharded torch.distributed mesh."""
