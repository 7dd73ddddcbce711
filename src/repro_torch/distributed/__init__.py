"""Distribution layer: the per-family sharding rules (``sharding``); the
meshes are built by ``repro_torch.launch.mesh``."""
