from .synthetic import PlaneScene

__all__ = ["PlaneScene"]
