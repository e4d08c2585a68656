"""Launch: device meshes over ``torch.distributed`` (``mesh``) and the
distributed training driver (``python -m repro_torch.launch.train``); port
of ``repro/launch`` (the TPU dry-run, HLO analysis and sweep tools are not
ported)."""
