"""One World on one card: ``nbody_tpu_torch.create_world`` with the
configuration's ``sim`` fields and ``backend``."""


def build(nbt, cfg: dict, scene: dict, device):
    particles = nbt.make_particles(scene["pos"], vel=scene["vel"],
                                   mass=scene["mass"], radius=scene["radius"])
    return nbt.create_world(particles, config=nbt.SimConfig(**cfg["sim"]),
                            default_backend=cfg["backend"], device=device)
