from repro_torch.data.pipeline import SyntheticLMDataset, PrefetchLoader

__all__ = ["SyntheticLMDataset", "PrefetchLoader"]
