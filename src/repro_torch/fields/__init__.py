from .synthetic import FIELD_BASE, synthetic_field

__all__ = ["FIELD_BASE", "synthetic_field"]
