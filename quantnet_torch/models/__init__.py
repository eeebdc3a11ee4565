"""The port's models. Each model's `apply` takes an optional `capture` dict."""


def capture_input(capture, path: str, x, spec: tuple) -> None:
    """Record a BN-folded layer's input under its path in `capture`, and its
    op spec (kind, stride, padding, activation) in capture["__specs__"] when
    the caller seeded that key: the spec lets the accuracy tools replay the
    layer outside the model (quantize/adaround.py, bias_correct.py). kind is
    "conv", "dwconv" (groups = the input's channels) or "linear"; padding is
    what the model passed to the op. Calibration seeds no specs, so its
    capture holds tensors only."""
    if capture is None:
        return
    capture[path] = x
    specs = capture.get("__specs__")
    if specs is not None:
        specs[path] = spec
