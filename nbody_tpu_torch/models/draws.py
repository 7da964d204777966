"""The random draws of the port's scene generators.

Every generator of ``nbody_tpu_torch.models`` takes its random numbers
through one :class:`Draws`, in the order in which its counterpart in
``nbody_tpu/models`` calls ``jax.random``, and each of its five methods
applies ``jax.random``'s own range formula to unit draws:

* ``uniform(shape, lo, hi)``: ``max(lo, u * (hi - lo) + lo)`` in fp32, u
  in [0, 1), as ``jax.random.uniform`` forms it;
* ``normal(shape)``: standard normals;
* ``randint(shape, lo, hi)``: ``lo + min(floor(u * (hi - lo)), hi - lo - 1)``;
  ``hi`` may be a tensor of per-row bounds, which ``torch.randint`` cannot
  take;
* ``bernoulli(shape, p)``: ``u < p``;
* ``dirichlet_ones(g)``: Dirichlet(1, ..., 1), unit exponentials divided by
  their sum (``torch.distributions.Dirichlet`` takes no generator).

The unit draws come from :meth:`Draws.unit`, :meth:`Draws.normal` and
:meth:`Draws.unit_exponential`; a subclass that overrides those three
hands a generator any draws it likes (the tests give both packages the
same ones).

Three random streams, none equal to another: JAX's, PyTorch's on the CPU
(mt19937) and PyTorch's on the card (Philox). A scene drawn on the card is
therefore not bit-equal to the same seed drawn on the CPU, nor to
``nbody_tpu``'s; each is deterministic per seed on its own device.
"""

from __future__ import annotations

import numbers

import torch

from ..types import DTYPE


def _f32(x, device) -> torch.Tensor:
    """``x`` as fp32 on ``device``: a tensor as it is, a number as a 0-dim
    tensor filled there (no host copy)."""
    if isinstance(x, torch.Tensor):
        return x.to(DTYPE)
    return torch.full((), float(x), dtype=DTYPE, device=device)


class Draws:
    """The draws of one scene, from ``generator`` on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.device = generator.device

    # -- unit draws ------------------------------------------------------
    def unit(self, shape) -> torch.Tensor:
        """fp32 uniforms in [0, 1)."""
        return torch.rand(shape, generator=self.generator, dtype=DTYPE,
                          device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """Standard normals."""
        return torch.randn(shape, generator=self.generator, dtype=DTYPE,
                           device=self.device)

    def unit_exponential(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=DTYPE, device=self.device).exponential_(
            generator=self.generator)

    # -- jax.random's range formulas on the unit draws -----------------------
    def uniform(self, shape, lo=0.0, hi=1.0) -> torch.Tensor:
        lo, hi = _f32(lo, self.device), _f32(hi, self.device)
        return torch.maximum(lo, self.unit(shape) * (hi - lo) + lo)

    def randint(self, shape, lo, hi) -> torch.Tensor:
        """int64 draws in [lo, hi); ``hi`` (and ``lo``) may be per-row
        integer tensors."""
        span = _f32(hi - lo, self.device)
        k = torch.minimum(torch.floor(self.unit(shape) * span), span - 1.0)
        return lo + k.to(torch.int64)

    def bernoulli(self, shape, p) -> torch.Tensor:
        return self.unit(shape) < p

    def dirichlet_ones(self, g: int) -> torch.Tensor:
        e = self.unit_exponential((g,))
        return e / e.sum()


def draws_for(generator, device="cuda") -> Draws:
    """The :class:`Draws` of a generator argument: a :class:`Draws` as it
    is, a ``torch.Generator`` on its own device, or an int seed for a new
    generator on ``device`` ("cuda" unless given). Without a card, "cuda"
    raises; it does not fall back to the CPU."""
    if isinstance(generator, Draws):
        return generator
    if isinstance(generator, torch.Generator):
        return Draws(generator)
    if isinstance(generator, numbers.Integral) and not isinstance(generator, bool):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but "
                               "torch.cuda.is_available() is False")
        return Draws(torch.Generator(device=device).manual_seed(int(generator)))
    raise TypeError("generator must be an int seed, a torch.Generator or a "
                    f"Draws, got {type(generator).__name__}")
