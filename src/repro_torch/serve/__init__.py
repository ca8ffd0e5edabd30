from repro_torch.serve.engine import InferenceServer, Gateway, Request

__all__ = ["InferenceServer", "Gateway", "Request"]
