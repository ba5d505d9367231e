"""Launch layer: meshes and the training main."""
