"""One factory a kind of world: ``perfbench/worlds/<world>.py``, named by the
``"world"`` key of a configuration, holds ``build(nbt, cfg, scene, device)``,
which makes the program's world of the configuration from the scene."""
