from .precision import full_f32

__all__ = ["full_f32"]
