from .libc_rand import LibcRand

__all__ = ["LibcRand"]
