"""The ablation path of the direct force: counterparts of the TPU scripts in
``scripts/ablations/`` (``tune_r2.py``, ``tune_r2g.py``, ``tune_r2d.py``,
``tune_r2h.py``, ``tune_r2b.py``, ``tune_r2e.py``, ``tune_r2c.py``,
``tune_r2f.py``, ``tune_r4d_bcast_probe.py``), each a module run on the card
with

    python -m nbody_tpu_torch.ablations.<name>

The direct-force modules build the N=65536 two-galaxy bench scene (seed
11037), form their script's source and target rows, run their kernel over
the script's sweep translated to Hopper parameters, and print one line per
configuration: µs, pairs/s, max|Δ|/max|ref| against the kernel's plain
version, and the ratio to the direct kernel's ``force_acc`` on the same
inputs. The two probes (``tune_r2f``, ``tune_r4d_bcast_probe``) run at their
scripts' shapes on inputs drawn with numpy.

``tune_direct`` has no TPU script: it sweeps the plans of the main-path
pair loop (``csrc/direct_tiles.cuh``) from which ``cluster_plan`` was
chosen. Nor has ``pm_momentum``: the "pm" horizon case's momentum under
an fp32, an odd-spectrum fp32 and the float64 mesh solve, on the CPU and
the card, from which ``ops/pm_forces._solve``'s float64 was chosen. Without a CUDA device each module raises.
"""
