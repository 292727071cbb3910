"""import-reference CLI on PyTorch: migrate an upstream-trained checkpoint.

Counterpart of video_captioning_tpu/cli/import_reference.py. A user of the
upstream project (angadbawa/Video-Captioning) holds torch-saved
artifacts: its inference package (``model_for_inference.pth``), a training
checkpoint, or a raw ``VideoCaptioningModel.state_dict()``. This CLI turns
any of them into an inference package of this project, with a standalone
``vocabulary.json``, which both packages serve:

    python -m video_captioning_tpu_torch.cli.import_reference \\
        --input checkpoints/model_for_inference.pth --output-dir converted/

The port's modules carry the upstream parameter names, so the state dict
converts through the weight bridge (``models.weights.jax_params_from_state_dict``)
and the package is written by ``utils.checkpoint``. Raw state dicts and
training checkpoints carry no vocabulary: pass ``--vocabulary
vocabulary.json``. Architecture fields come from the embedded upstream
config where there is one, else from ``--config``. The upstream decoder
is Bahdanau attention; ``--attention-type luong|multihead`` converts a
checkpoint of a decoder modified to another type (Luong's score comes
from the config's ``luong_score``), as the JAX CLI does.

Upstream packages pickle the upstream ``Config`` object, whose classes
live in modules this project does not ship (``src.config.config``). The
loader installs permissive stub modules while it unpickles, so those
objects load as attribute bags whose fields are read and whose code never
runs. Files load onto the CPU whatever the device; no device is needed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import types
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

from ..config import Config
from ..utils.logging import setup_logging

logger = logging.getLogger(__name__)

# Module names an upstream pickle may name for its config classes, by how
# its training was launched (repo root, installed package, module run).
_STUB_MODULE_NAMES = ("src", "src.config", "src.config.config", "config", "config.config")


class _StubObject:
    """Attribute bag standing in for any upstream class while unpickling
    (plain-object pickles rebuild through ``__new__`` and ``__dict__``)."""

    def __repr__(self) -> str:
        return f"_StubObject({self.__dict__!r})"


def _install_unpickle_stubs() -> list:
    """Register stub modules whose every non-dunder attribute is a fresh
    stub class; returns the names installed, for removal after the load.
    A module already imported is never replaced."""
    installed = []
    for name in _STUB_MODULE_NAMES:
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        mod.__path__ = []  # a package, so submodule lookups succeed

        def _getattr(attr: str, _mod_name=name):
            if attr.startswith("__") and attr.endswith("__"):
                raise AttributeError(attr)
            # One class per (module, attr), so one load's memo stays coherent.
            cls = type(attr, (_StubObject,), {"__module__": _mod_name})
            setattr(sys.modules[_mod_name], attr, cls)
            return cls

        mod.__getattr__ = _getattr
        sys.modules[name] = mod
        installed.append(name)
    return installed


def load_reference_file(path: Path) -> Any:
    """``torch.load`` an upstream artifact onto the CPU with the stubs
    installed (``weights_only=False``: the artifacts pickle config and
    vocabulary objects beside the tensors)."""
    import torch

    installed = _install_unpickle_stubs()
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for name in installed:
            sys.modules.pop(name, None)


def _looks_like_state_dict(obj: Any) -> bool:
    return (isinstance(obj, Mapping) and bool(obj) and all(isinstance(k, str) for k in obj)
            and any(k.startswith(("encoder.", "decoder.")) for k in obj))


def extract_state_and_metadata(obj: Any) -> Dict[str, Any]:
    """Split a loaded upstream artifact into ``state_dict``, ``ref_config``
    (or None), ``vocabulary`` (the raw upstream dict or None) and
    ``source_kind``."""
    if _looks_like_state_dict(obj):
        return {"state_dict": obj, "ref_config": None, "vocabulary": None,
                "source_kind": "state_dict"}
    if isinstance(obj, Mapping) and "model_state_dict" in obj:
        return {"state_dict": obj["model_state_dict"],
                "ref_config": obj.get("model_config") or obj.get("config"),
                "vocabulary": obj.get("vocabulary"),
                "source_kind": ("inference_package" if "vocabulary" in obj
                                else "training_checkpoint")}
    raise SystemExit(
        "input does not look like an upstream artifact: expected an inference package / "
        "training checkpoint (dict with 'model_state_dict') or a raw "
        "VideoCaptioningModel.state_dict()")


def config_from_reference(ref_config: Any, base: Optional[Config] = None) -> Config:
    """Copy the fields of a deserialized upstream Config tree whose names
    match this project's, section by section; the rest keep their values."""
    config = base if base is not None else Config()
    if ref_config is None:
        return config
    for section in ("model", "data", "training", "inference", "experiment"):
        ref_section = getattr(ref_config, section, None)
        ours = getattr(config, section, None)
        if ref_section is None or ours is None:
            continue
        ref_attrs = getattr(ref_section, "__dict__", {})
        for f in dataclasses.fields(ours):
            if f.name not in ref_attrs:
                continue
            value = ref_attrs[f.name]
            if isinstance(value, _StubObject):
                continue  # a nested object this project does not model
            current = getattr(ours, f.name)
            try:
                setattr(ours, f.name, type(current)(value) if current is not None else value)
            except (TypeError, ValueError):
                setattr(ours, f.name, value)
    return config


def migrate(input_path: Path, output_dir: Path, vocabulary_path: Optional[Path] = None,
            attention_type: str = "bahdanau", model_name: str = "model_for_inference.pth",
            base_config: Optional[Config] = None) -> Dict[str, Any]:
    """Upstream artifact -> this project's inference package and
    ``vocabulary.json`` in ``output_dir``; returns a summary."""
    import numpy as np
    import torch

    from ..data.vocabulary import Vocabulary
    from ..models.weights import jax_params_from_state_dict
    from ..utils.checkpoint import CheckpointManager, _leaves, vocabulary_from_package

    parts = extract_state_and_metadata(load_reference_file(Path(input_path)))
    config = config_from_reference(parts["ref_config"], base=base_config)
    # The upstream decoder is Bahdanau attention and its config has no
    # attention_type field; the upstream project has one family.
    config.model.attention_type = attention_type
    config.model.architecture = "lstm"
    if parts["vocabulary"] is not None:
        vocab = vocabulary_from_package({"vocabulary": parts["vocabulary"]}, config)
    elif vocabulary_path is not None:
        vocab = Vocabulary.load(Path(vocabulary_path), config)
    else:
        raise SystemExit(f"{parts['source_kind']} carries no vocabulary; pass --vocabulary "
                         "vocabulary.json (written by the upstream train.py beside its "
                         "checkpoints)")
    config.data.max_vocab_size = len(vocab)  # the upstream config keeps them in sync
    config.validate()

    state = {k: torch.as_tensor(v) for k, v in parts["state_dict"].items()}
    params = jax_params_from_state_dict(state, config)

    output_dir = Path(output_dir)
    package_path = CheckpointManager(output_dir).save_model_for_inference(
        params, vocab, config, model_name=model_name)
    vocab_path = output_dir / "vocabulary.json"
    vocab.save(vocab_path)
    summary = {
        "source": str(input_path),
        "source_kind": parts["source_kind"],
        "output": str(package_path),
        "vocabulary": str(vocab_path),
        "vocab_size": len(vocab),
        "attention_type": attention_type,
        "parameters": int(sum(np.asarray(x).size for x in _leaves(params))),
    }
    logger.info("migrated %(source_kind)s %(source)s -> %(output)s "
                "(%(parameters)d params, vocab %(vocab_size)d)", summary)
    return summary


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Migrate an upstream-trained torch checkpoint into this project's "
                    "inference package (PyTorch)")
    parser.add_argument("--input", type=str, required=True,
                        help="Upstream artifact: model_for_inference.pth, "
                             "checkpoint_epoch_*.pth / best_model.pth, or a raw state_dict .pth")
    parser.add_argument("--output-dir", type=str, required=True,
                        help="Directory for the converted inference package and "
                             "vocabulary.json")
    parser.add_argument("--vocabulary", type=str, default=None,
                        help="vocabulary.json for artifacts that embed none (training "
                             "checkpoints, raw state dicts)")
    parser.add_argument("--attention-type", type=str, default="bahdanau",
                        choices=["bahdanau", "luong", "multihead"],
                        help="Attention type of the migrated decoder (the upstream "
                             "decoder is bahdanau)")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML/JSON config seeding the architecture for artifacts that "
                             "embed none; an embedded upstream config overrides it")
    parser.add_argument("--model-name", type=str, default="model_for_inference.pth")
    parser.add_argument("--log-level", type=str, default="INFO")
    return parser


def main(argv=None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    setup_logging(args.log_level)
    summary = migrate(
        Path(args.input), Path(args.output_dir),
        vocabulary_path=Path(args.vocabulary) if args.vocabulary else None,
        attention_type=args.attention_type, model_name=args.model_name,
        base_config=Config.from_file(Path(args.config)) if args.config else None)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
