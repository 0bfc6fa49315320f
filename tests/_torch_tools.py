"""Shared pieces of the tests that hold ``ircl_tpu_torch/tools/`` to the
reference's experiment scripts in ``scripts/``.

The scripts keep their logic inside ``main()`` and read ``sys.argv``, so the
tests load each script as a module and run its ``main()`` in the test
process, with JAX on the CPU, ``--out`` in a temporary directory and only its
heavy library calls replaced by recorders.
"""

import contextlib
import dataclasses
import importlib.util
import os
import sys

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A contrastive encoder narrow enough for a test, set alike in both packages:
# the scripts build FeaturizerConfig(dim=768, ...) and EncoderConfig(...)
# inside main(), so both modules' names are replaced by these narrowings.
NARROW_FEATURIZER = dict(dim=16, vocab_buckets=4096)
NARROW_ENCODER = dict(input_size=16, hidden_size=8, output_size=8, num_layers=1)


def load_script(name: str):
    """``scripts/<name>.py`` as a module (its top level imports no JAX)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def narrowed(cls, widths):
    """A stand-in for the config class ``cls`` that overrides ``widths``."""
    return lambda **kw: cls(**{**kw, **widths})


def narrow_contrastive(mp, featurizer_owner, encoder_owner):
    """Replaces ``FeaturizerConfig`` and ``EncoderConfig`` where the script
    or tool looks them up."""
    mp.setattr(featurizer_owner, "FeaturizerConfig",
               narrowed(featurizer_owner.FeaturizerConfig, NARROW_FEATURIZER))
    mp.setattr(encoder_owner, "EncoderConfig",
               narrowed(encoder_owner.EncoderConfig, NARROW_ENCODER))


def untrained(calls):
    """A ``ContrastiveTrainer.train`` that records the run it was asked for
    and returns the trainer's initial state."""

    def train(self, total_steps=None, log_step=100):
        calls.append(dict(sample=self.sampler.sample, steps=total_steps,
                          similarity=self.sampler.similarity,
                          config=config_fields(self.config)))
        return self.state

    return train


def config_fields(cfg):
    """A config dataclass as a dict, nested dataclasses included."""
    return {f.name: (config_fields(getattr(cfg, f.name))
                     if dataclasses.is_dataclass(getattr(cfg, f.name))
                     else getattr(cfg, f.name))
            for f in dataclasses.fields(cfg)}


@contextlib.contextmanager
def reference_argv(mp, argv):
    """``sys.argv`` for a script's ``main()``; its persistent-cache setting
    of JAX's config is dropped, so the test writes nothing outside its
    temporary directory."""
    update = jax.config.update

    def no_cache_dir(name, value):
        if name != "jax_compilation_cache_dir":
            update(name, value)

    mp.setattr(sys, "argv", ["script", *argv])
    mp.setattr(jax.config, "update", no_cache_dir)
    yield


def section(path, begin, end):
    """The text between ``begin`` and ``end`` in ``path``, markers included."""
    text = open(path).read()
    i, j = text.index(begin), text.index(end)
    assert text.count(begin) == 1 and text.count(end) == 1
    return text[i: j + len(end)]


def table_rows(text, first_cell):
    """The cells of the markdown table rows whose first cell is in
    ``first_cell`` (a set) or, with None, of every row past a header."""
    rows = []
    for line in text.splitlines():
        if not line.startswith("| ") or line.startswith("|---"):
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if first_cell is None or cells[0] in first_cell:
            rows.append(cells)
    return rows
