"""The port's examples: one module for each of ``examples/`` in the JAX
package, with its file name, flags, defaults, seeds and printed lines, run
as ``python -m byteps_tpu_torch.examples.<name>`` (or under ``python -m
byteps_tpu_torch.launcher.launch -- python -m ...``).  Each adds
``--device``: the card by default (``cuda:<local rank>``, through
``init()``, which raises without one); ``cpu`` runs one without a card.
README.md lists the commands."""
