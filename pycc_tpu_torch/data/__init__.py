from .molecules import moldict, water_cluster

__all__ = ["moldict", "water_cluster"]
