from repro_torch.configs.base import ArchConfig, ShapeConfig, SHAPES, get_arch, list_archs

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "list_archs"]
