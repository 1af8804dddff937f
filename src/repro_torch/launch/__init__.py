"""Entry points of the port (counterpart of ``repro/launch/``):
``python -m repro_torch.launch.serve``, the serving CLI on one card.
The training CLI and the mesh modules are not ported yet
(ROADMAP.md)."""
