"""Entry points of the port (counterpart of ``repro/launch/``):
``python -m repro_torch.launch.serve``, the serving CLI, and
``python -m repro_torch.launch.train``, the SVI training CLI with
checkpoint and resume, both on one card. The mesh modules are not ported
yet (ROADMAP.md)."""
