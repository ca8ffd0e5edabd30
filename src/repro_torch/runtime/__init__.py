from repro_torch.runtime.sharding import Sharder

__all__ = ["Sharder"]
