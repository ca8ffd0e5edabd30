from repro_torch.models.base import ParamSpec, init_tree, params_from_numpy

__all__ = ["ParamSpec", "init_tree", "params_from_numpy"]
