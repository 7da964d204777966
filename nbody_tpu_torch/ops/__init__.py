from .direct_forces import force_acc, fused_substep

__all__ = ["force_acc", "fused_substep"]
