"""Launch layer: meshes over a process group, input specs and cells, the
training main (`python -m repro_torch.launch.train`, or under torchrun
over ranks), and the census of every cell on the production meshes
(`python -m repro_torch.launch.dryrun`, counted by `launch.step_stats`
on meta tensors).

Port of `repro.launch`; `step_stats` stands in for `hlo_stats`, which
parses compiled HLO the port does not have."""
