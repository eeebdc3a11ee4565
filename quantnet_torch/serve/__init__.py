from quantnet_torch.serve.server import InferenceEngine  # noqa: F401
