"""Detector families: what the harness knows of each, one file a family.

``families/<architecture>.py`` is found by the configuration's
``pipeline.model.architecture``. It gives:

  MODEL              the float32 reference model class (its module under
                     ``reference/``, or the family file itself), built as
                     ``MODEL(cfg, extents)`` and called as ``model(inputs)``;
                     a two-stage model also takes ``picks=`` and
                     ``proposals=``, which replace its RPN's NMS and the
                     boxes stage 2 crops at;
  PORT_NMS_MODULES   the port's modules (dotted names) whose module-level
                     ``top_k_nms_batch`` (the RPN's) and ``nms_batch`` (the
                     final per-class NMS) the timed path calls: the
                     harness's recorder and the planted faults wrap them;
  FUSION_LAYERS      the module names of its fusion layers, which carry the
                     image's features into the BEV (and back), SHPL or
                     other: the same names in the port and the reference
                     (``fusion`` reads the widest gap over those present);
  NMS_SPANS          the program's spans that hold its greedy NMS calls;
  feature_layers(names)
                     ``{"rpn": ..., "s2": ...}``: the module names whose
                     outputs feed the RPN's and stage 2's heads, from the
                     set of the model's module names; a one-stage family's
                     is ``{"rpn": ...}`` alone, its dense head's hidden
                     layer;
  anchor_grid(cfg, extents)
                     the static anchor grid, numpy [N, 8] f32 with y = 0;
  frame_anchors(anchors_frame, occupancy, cfg, extents)
                     a frame's anchors [B, A, 8] and their validity [B, A]
                     from the grid on each frame's ground plane and the BEV
                     occupancy raster;
  decode(outputs, ground_plane, cfg, extents, picks)
                     the final detections (``picks`` replaces the final NMS),
                     with ``picks``, ``bev_all`` and ``class_scores`` as
                     ``reference/detector.per_class_nms`` gives them;
  flops(cfg, extents)
                     the model FLOPs of one frame's serving forward, built
                     from ``harness/flops.py``'s shared counts;
  nms_rounds(cfg)    the greedy NMS rounds of one frame of a request;

and, where the family has them:

  STAGES             1 or 2 (the default): the detector's stages. Two stages
                     pick proposals by the RPN's NMS (``top_k_nms_batch``),
                     run stage 2 over them and decode its heads; one stage
                     decodes its dense head at every anchor, and its
                     detections are its final per-class NMS's picks alone
                     (the ``nms_batch`` calls of ``PORT_NMS_MODULES``; it
                     calls no ``top_k_nms_batch``). The numbers the judge
                     reads, and so the limits a cell of the family names,
                     follow from it (``harness/judge.py``);
  SHARED_INPUTS      the shared model inputs its model reads, each recorded
                     and compared by ``inputs``: by default every one
                     (``DEFAULT_SHARED_INPUTS``); a family that pools no SHPL
                     table leaves out ``m_bev`` and ``m_fv``;
  MODEL_KEYS         ``{key: parse}`` for ``pipeline.model`` keys that
                     ``reference/config.py`` does not know: ``parse(value)``
                     gives the key's value in the parsed configuration;
  INPUTS             the model inputs it adds beyond the shared ones, each
                     compared by ``inputs`` as the shared ones are;
  extra_inputs(batch, cfg, extents)
                     the reference's build of those inputs, a dict;
  frame(frame, seed) a traffic frame (host numpy, keyed like ``RawSample``)
                     with what the family's frames carry beyond the shared
                     generator's (``traffic/frames.py``), drawn from the
                     frame's own ``seed``.

A new family is a new file here and its reference model (a module of its
own, or in the family file); nothing in
``harness/``, ``reference/pipeline.py``, ``reference/config.py``,
``run.py`` or ``control.py`` names one.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional

HOME = Path(__file__).resolve().parent.parent  # the benchmark folder these files belong to

REQUIRED = ("MODEL", "PORT_NMS_MODULES", "FUSION_LAYERS", "NMS_SPANS", "feature_layers", "anchor_grid",
            "frame_anchors", "decode", "flops", "nms_rounds")


def _no_inputs(batch, cfg, extents) -> Dict:
    return {}


def _same_frame(frame: Dict, seed: int) -> Dict:
    return frame


# the model inputs the shared input build makes (``reference/pipeline.py``)
DEFAULT_SHARED_INPUTS = ("bev_input", "bev_pre_packed", "image", "anchors", "anchor_valid", "m_bev", "m_fv")

OPTIONAL = {"STAGES": 2, "SHARED_INPUTS": DEFAULT_SHARED_INPUTS, "MODEL_KEYS": {}, "INPUTS": (),
            "extra_inputs": _no_inputs, "frame": _same_frame}

# loaded family files by resolved path: one module a file, so that the
# classes a file defines are the same on every lookup
_LOADED: Dict[Path, ModuleType] = {}


def load(architecture: str, bench_dir: Optional[Path] = None) -> ModuleType:
    """The family file ``<bench_dir>/families/<architecture>.py`` (the
    benchmark folder of this package without ``bench_dir``)."""

    folder = Path(bench_dir) if bench_dir is not None else HOME
    path = (folder / "families" / f"{architecture}.py").resolve()
    if path in _LOADED:
        return _LOADED[path]
    if not path.is_file():
        raise FileNotFoundError(f"architecture {architecture!r} has no family file: "
                                f"{folder.name}/families/{architecture}.py is missing ({path})")
    spec = importlib.util.spec_from_file_location(f"bench_family_{architecture}_{len(_LOADED)}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [name for name in REQUIRED if not hasattr(module, name)]
    if missing:
        raise AttributeError(f"family file {path} lacks {', '.join(missing)}")
    for name, default in OPTIONAL.items():
        if not hasattr(module, name):
            setattr(module, name, default)
    if module.STAGES not in (1, 2):
        raise ValueError(f"family file {path} has STAGES = {module.STAGES!r}: 1 or 2")
    _LOADED[path] = module
    return module


def every(bench_dir: Optional[Path] = None) -> List[ModuleType]:
    """Every family file of the benchmark folder."""

    folder = Path(bench_dir) if bench_dir is not None else HOME
    return [load(p.stem, folder) for p in sorted((folder / "families").glob("*.py")) if p.stem != "__init__"]


def last_numbered(names: Iterable[str], prefix: str) -> str:
    """``<prefix><n>``, n the count of ``names`` that are ``prefix`` and a
    number: the last of layers numbered from 1 (``stage2_head.fc`` -> the
    stage-2 head's last FC of its one stack)."""

    n = sum(1 for name in names if name.startswith(prefix) and name[len(prefix):].isdigit())
    return f"{prefix}{n}"
