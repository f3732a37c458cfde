"""``python -m byteps_tpu_torch.server``: start a server or the scheduler
per DMLC_ROLE (the reference: ``python -m byteps_tpu.server``)."""

from byteps_tpu_torch.server.server import run_server

if __name__ == "__main__":
    run_server()
