"""Scene generators of the port: the numpy spiral galaxies and the
bit-exact reference scene."""

from ..galaxy import make_galaxies
from .galaxy_ref import make_galaxies_libc

__all__ = ["make_galaxies", "make_galaxies_libc"]
