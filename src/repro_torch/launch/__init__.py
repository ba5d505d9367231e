"""Launch layer: meshes over a process group, input specs and cells, and
the training main (`python -m repro_torch.launch.train`, or under
torchrun over ranks).

Port of `repro.launch` but its dry-run and HLO tooling."""
