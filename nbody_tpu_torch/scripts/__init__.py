"""Runnable scripts of the port, the counterparts of the repository's
``scripts/validate_physics.py``, ``scale_ceiling.py`` and
``verify_drive.py``:

    python -m nbody_tpu_torch.scripts.<name> [arguments] [--device cpu]

Each takes its JAX script's positional arguments and defaults, with the
port's backend names ("cuda" for "pallas", "torch" for "jnp", "pm",
"p3m"), and prints its JAX script's lines. It runs on the card ("cuda")
unless ``--device cpu`` is given, and raises without a card: no script
falls back to the CPU. Each ``main(argv)`` returns its numbers as a dict.
"""
