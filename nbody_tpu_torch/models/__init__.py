"""Scene generators of the port: the numpy spiral galaxies and the
bit-exact reference scene (host), and the spiral galaxies, Plummer, Kepler
and cold-collapse disks drawn on the device."""

from ..galaxy import make_galaxies
from .disks import make_cold_disk, make_kepler_disk
from .galaxy_device import make_galaxies_device
from .galaxy_ref import make_galaxies_libc
from .plummer import make_plummer_disk

__all__ = ["make_galaxies", "make_galaxies_device", "make_galaxies_libc",
           "make_plummer_disk", "make_kepler_disk", "make_cold_disk"]
