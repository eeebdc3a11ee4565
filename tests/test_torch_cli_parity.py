"""The port's command line against the JAX CLI's (quantnet/cli/main.py),
subcommand by subcommand, and `experiment --importance` carried into its
quantize stage (ROADMAP Queue 3 item 17).

The parsers must take the same flags with the same destinations, defaults,
choices, types, actions and nargs. The named exceptions, and no others:
- `--device`, which only the port has (the card by default, `cpu` for tests);
- `serve --scheme`'s default: None in the port, which serves `static` when
  it is on disk and refuses a named scheme that is not (Queue 3 item 18);
- `experiment --observer`'s choices: the port lists the four observers, the
  JAX CLI takes any name and fails later, inside calibration (Queue 3 item 19).
"""
import argparse
import json
import shutil

import numpy as np
import pytest

from quantnet.cli.main import build_parser as jax_parser
from quantnet_torch.cli.main import build_parser as port_parser
from quantnet_torch.cli.main import main
from test_torch_cli import CKPT, _dirs

OBSERVERS = ["minmax", "moving_average", "histogram", "mse"]
# (subcommand, flag) -> (dest, default, choices) in the JAX CLI, in the port.
EXCEPTIONS = {
    ("serve", "--scheme"): (("scheme", "static", None), ("scheme", None, None)),
    ("experiment", "--observer"): (("observer", "minmax", None), ("observer", "minmax", OBSERVERS)),
}


def _flags(parser) -> dict:
    """{subcommand: {flag: (dest, default, choices, type, action, required, nargs)}}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.option_strings[0]: (a.dest, a.default, a.choices, a.type, type(a).__name__,
                                         a.required, a.nargs)
                   for a in sp._actions if a.option_strings and a.dest != "help"}
            for name, sp in sub.choices.items()}


JAX, PORT = _flags(jax_parser()), _flags(port_parser())


def test_same_subcommands():
    assert sorted(JAX) == sorted(PORT) == sorted(
        ["bench", "evaluate", "experiment", "import-torch", "qat", "quantize", "report", "scaling",
         "serve", "train"])


@pytest.mark.parametrize("cmd", sorted(JAX))
def test_parser_matches_the_jax_cli(cmd):
    j, p = dict(JAX[cmd]), dict(PORT[cmd])
    device = p.pop("--device")
    assert "--device" not in j
    assert device[:3] == ("device", "cuda", None)
    assert j["--importance"] == p["--importance"] == (
        "importance", None, [None, "sensitivity", "static_map"], None, "_StoreAction", False, None)
    for (c, flag), (jwant, pwant) in EXCEPTIONS.items():
        if c == cmd:
            assert j.pop(flag)[:3] == jwant and p.pop(flag)[:3] == pwant, flag
    assert sorted(j) == sorted(p)
    for flag in j:
        assert j[flag] == p[flag], flag


def test_every_subcommand_takes_importance():
    for cmd in sorted(PORT):
        argv = [cmd, "--importance", "static_map"] + (["--ckpt", "x.pth"] if cmd == "import-torch" else [])
        assert port_parser().parse_args(argv).importance == "static_map"


@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """import-torch (the reference convnet checkpoint), then experiment
    --skip-training --importance static_map at a tiny size; and in a second
    directory, quantize --scheme optimized --importance static_map on a copy
    of the same fp32 artifact."""
    base = tmp_path_factory.mktemp("parity")
    tiny = ["--synthetic-train-size", "64", "--synthetic-test-size", "32", "--batch-size", "32",
            "--device", "cpu"]
    d = _dirs(base / "experiment") + tiny
    main(["import-torch", "--ckpt", CKPT, *d])
    main(["experiment", "--skip-training", "--qat-epochs", "0", "--importance", "static_map",
          "--calibration-batches", "2", "--batch-sizes", "1", "--warmup", "0", "--iters", "1", *d])
    (base / "quantize" / "saved").mkdir(parents=True)
    for suffix in (".json", ".npz"):
        shutil.copy(base / "experiment" / "saved" / f"fp32{suffix}", base / "quantize" / "saved")
    main(["quantize", "--scheme", "optimized", "--importance", "static_map", "--calibration-batches",
          "2", *_dirs(base / "quantize"), *tiny])
    return base


def test_experiment_optimized_equals_quantize_static_map(experiment):
    """The experiment's optimized artifact, leaf for leaf and in its
    metadata, is quantize --scheme optimized --importance static_map's; its
    policy is the one the static importance map gives."""
    from quantnet_torch.quantize.fold import fold_model
    from quantnet_torch.quantize.policy import build_policy, layer_paths, static_importance_map
    from quantnet_torch.train import checkpoint as tckpt

    a, b = (experiment / name / "saved" / "optimized" for name in ("experiment", "quantize"))
    with np.load(f"{a}.npz") as za, np.load(f"{b}.npz") as zb:
        assert sorted(za.files) == sorted(zb.files) and za.files
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)
    meta_a = json.loads(a.with_suffix(".json").read_text())
    meta_b = json.loads(b.with_suffix(".json").read_text())
    assert meta_a == meta_b
    tree, _ = tckpt.load_artifact(str(experiment / "experiment" / "saved" / "fp32"), device="cpu")
    fparams, _ = fold_model(tree["params"], tree["state"])
    want = build_policy(static_importance_map(layer_paths(fparams)))
    assert meta_a["metadata"]["policy"] == want


def test_experiment_reports_every_scheme(experiment):
    report = (experiment / "experiment" / "results" / "detailed_analysis_report.md").read_text()
    for name in ("fp32", "static", "dynamic", "optimized", "w4a8"):
        assert f"| {name} |" in report, name
