"""The PS server and the scheduler of the port, as processes:
``DMLC_ROLE=server|scheduler python -m byteps_tpu_torch.server``."""
