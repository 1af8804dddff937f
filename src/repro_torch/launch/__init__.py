"""Entry points of the port (counterpart of ``repro/launch/``):
``python -m repro_torch.launch.serve``, the serving CLI on one card;
``python -m repro_torch.launch.train``, the SVI training CLI with
checkpoint and resume, on one card or a mesh (``--devices`` / ``--mesh``);
``python -m repro_torch.launch.dryrun`` and ``report``, the dry-run of
every (arch x shape x mesh) cell on a fake 256- or 512-rank mesh. The
mesh modules: ``mesh.py``, ``sharding.py``, ``programs.py``, ``costs.py``
and ``roofline.py``."""
