"""The ablation path of the direct force: counterparts of the TPU scripts in
``scripts/ablations/`` (``tune_r2.py``, ``tune_r2g.py``, ``tune_r2d.py``,
``tune_r2h.py``), each a module run on the card with

    python -m nbody_tpu_torch.ablations.<name>

Each builds the N=65536 two-galaxy bench scene (seed 11037), forms its
script's source and target rows, runs its kernel over the script's sweep
translated to Hopper parameters, and prints one line per configuration:
µs, pairs/s, max|Δ|/max|ref| against the kernel's plain version, and the
ratio to the direct kernel's ``force_acc`` on the same inputs. Without a
CUDA device each raises.
"""
