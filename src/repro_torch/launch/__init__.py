"""Launch helpers of the port: meshes of ranks over torch.distributed."""
