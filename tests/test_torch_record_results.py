"""scripts/record_results_torch.py: the rows of scripts/record_results.py,
flag for flag, through the torch trainers, into results_torch.csv only."""

import torch_test_threads  # noqa: F401  (torch's threads a worker)

import importlib.util
import pathlib
import subprocess

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_rows(tmp_path, monkeypatch):
    """What scripts/record_results.py's main runs, recorded, its output
    pointed at a scratch file (it never reaches results.csv here)."""
    ref = _load("record_results")
    out = tmp_path / "reference.csv"
    monkeypatch.setattr(ref, "OUT", str(out))
    calls = []

    def record(script, *args):
        calls.append((script, list(args)))
        out.write_text("")

    monkeypatch.setattr(ref, "run", record)
    ref.main()
    return calls


@pytest.mark.parametrize("epochs", [None, "3"])
def test_rows_mirror_the_reference_flag_for_flag(tmp_path, monkeypatch,
                                                 epochs):
    if epochs is None:
        monkeypatch.delenv("EDGECONV_EPOCHS", raising=False)
    else:
        monkeypatch.setenv("EDGECONV_EPOCHS", epochs)
    want = _reference_rows(tmp_path, monkeypatch)
    got = _load("record_results_torch").rows(epochs or "20")
    assert len(got) == len(want) == 9
    for (script, args), (jscript, jargs) in zip(got, want):
        assert script == jscript.replace(".py", "_torch.py")
        assert args == jargs
        assert (ROOT / "scripts" / script).exists()


def test_main_writes_only_results_torch_csv(tmp_path, monkeypatch):
    """Every trainer run is a subprocess whose --output is
    results_torch.csv, replaced wholesale; results.csv is never opened."""
    rec = _load("record_results_torch")
    results = ROOT / "results.csv"
    before = results.read_bytes()
    out = tmp_path / "results_torch.csv"
    out.write_text("a stale row\n")
    monkeypatch.setattr(rec, "OUT", str(out))
    cmds = []

    def fake_run(cmd, cwd):
        cmds.append(cmd)
        assert cmd[cmd.index("--output") + 1] == str(out)
        with open(out, "a") as f:
            f.write(f"{pathlib.Path(cmd[1]).name}\n")
        return subprocess.CompletedProcess(cmd, 0)

    monkeypatch.setattr(rec.subprocess, "run", fake_run)
    rec.main()
    assert len(cmds) == 9
    assert "stale" not in out.read_text()
    assert out.read_text().count("train_gat_torch.py") == 4
    assert results.read_bytes() == before
    assert pathlib.Path(_load("record_results_torch").OUT).name \
        == "results_torch.csv"
