"""Process launchers: ``launch`` (one host: one worker process per local
GPU, or a server / scheduler) and ``dist_launcher`` (ssh fan-out over the
hosts of a job)."""
