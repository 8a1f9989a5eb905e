"""Config composition (counterpart of ``fiode_tpu/utils/config.py``): the
registry of config groups, YAML files with a ``defaults:`` list composed in
order (``group@path.key: Option`` included), CLI-style overrides
(``key.path=value``, ``+group=Option``, ``++key=value``) and ``${a.b.c}``
interpolation resolved after composition.

The port reads YAML with its own small reader (``load_yaml``, ``parse_value``)
and needs no YAML package: it takes block mappings and sequences, flow
``{...}`` and ``[...]`` collections, quoted and plain scalars and comments,
and resolves plain scalars as PyYAML's YAML 1.1 rules do (``1.0e-3`` is a
float, ``1e-3`` a string, ``true`` / ``on`` booleans, ``~`` null).  That
covers every file under ``configs/``; the tests hold it against
``yaml.safe_load`` there.
"""
from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Dict, List, Optional

__all__ = ["ConfigStore", "compose", "parse_overrides", "resolve",
           "load_yaml", "parse_value"]


# ---------------------------------------------------------------------------
# YAML subset
# ---------------------------------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _plain(text: str):
    """A plain scalar resolved by YAML 1.1's implicit rules."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v != "0" and v.startswith("0"):
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    return text


class _Flow:
    """Reader of one inline value: a flow collection or a scalar."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, flow: bool):
        self._ws()
        c = self.s[self.i:self.i + 1]
        if c == "{":
            return self._mapping()
        if c == "[":
            return self._sequence()
        if c in ("'", '"'):
            return self._quoted()
        return _plain(self._plain_text(flow, key=False))

    def _plain_text(self, flow: bool, key: bool) -> str:
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if flow and c in ",]}":
                break
            if key and c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", ",", "}"):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise ValueError(f"unterminated quote in {self.s!r}")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                nxt = self.s[self.i + 1]
                out.append({"n": "\n", "t": "\t", "0": "\0"}.get(nxt, nxt))
                self.i += 2
                continue
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1

    def _key(self):
        self._ws()
        if self.s[self.i] in ("'", '"'):
            return self._quoted()
        return _plain(self._plain_text(True, key=True))

    def _expect(self, chars: str) -> str:
        self._ws()
        c = self.s[self.i:self.i + 1]
        if not c or c not in chars:
            raise ValueError(f"expected one of {chars!r} at {self.i} in {self.s!r}")
        self.i += 1
        return c

    def _mapping(self) -> dict:
        self.i += 1
        out: dict = {}
        self._ws()
        if self.s[self.i] == "}":
            self.i += 1
            return out
        while True:
            k = self._key()
            self._expect(":")
            out[k] = self.value(flow=True)
            if self._expect(",}") == "}":
                return out

    def _sequence(self) -> list:
        self.i += 1
        out: list = []
        self._ws()
        if self.s[self.i] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(flow=True))
            if self._expect(",]") == "]":
                return out

    def end(self):
        self._ws()
        if self.i != len(self.s):
            raise ValueError(f"trailing text in {self.s!r}")


def parse_value(text: str):
    """One inline YAML value (a scalar or a flow collection)."""
    r = _Flow(text.strip())
    if r.s[:1] in ("{", "[", "'", '"'):
        v = r.value(flow=True)
        r.end()
        return v
    return _plain(r.s)


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in ("'", '"'):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(text: str):
    """'key: value' -> (key, value text) at the first ': ' (or a trailing
    ':') outside quotes; None if the line is no mapping entry."""
    r = _Flow(text)
    if text[:1] in ("'", '"'):
        key = r._quoted()
        rest = text[r.i:].lstrip()
        if not rest.startswith(":"):
            return None
        return key, rest[1:].strip()
    m = re.search(r":(?:\s|$)", text)
    if m is None or text[:1] in "{[":
        return None
    return _plain(text[:m.start()].strip()), text[m.end():].strip()


def load_yaml(text: str):
    """The YAML document ``text`` (the subset described above)."""
    lines = []
    for raw in text.splitlines():
        body = _strip_comment(raw)
        if body.strip() and body.strip() != "---":
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i, indent):
    if _is_item(lines[i][1]):
        out = []
        while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
            item = lines[i][1][1:].strip()
            i += 1
            if item:
                out.append(parse_value(item))
            elif i < len(lines) and lines[i][0] > indent:
                v, i = _block(lines, i, lines[i][0])
                out.append(v)
            else:
                out.append(None)
        return out, i
    if _split_key(lines[i][1]) is None:
        return parse_value(lines[i][1]), i + 1
    out = {}
    while i < len(lines) and lines[i][0] == indent and not _is_item(lines[i][1]):
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = parse_value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


class ConfigStore:
    _groups: Dict[str, Dict[str, dict]] = {}

    @classmethod
    def store(cls, group: str, name: str, node: dict):
        cls._groups.setdefault(group, {})[name] = node

    @classmethod
    def get(cls, group: str, name: str) -> dict:
        try:
            return copy.deepcopy(cls._groups[group][name])
        except KeyError:
            raise KeyError(
                f"no config node {name!r} in group {group!r}; "
                f"available: {sorted(cls._groups.get(group, {}))}"
            ) from None


def _register_defaults():
    cs = ConfigStore
    for name, (ch, size, ncls, mu, std) in {
        "MNIST": (1, 28, 10, [0.1307], [0.3081]),
        "FashionMNIST": (1, 28, 10, [0.5], [0.5]),
        "CIFAR10": (3, 32, 10, [0.485, 0.456, 0.406], [0.225, 0.225, 0.225]),
        "CIFAR3": (3, 32, 3, [0.485, 0.456, 0.406], [0.225, 0.225, 0.225]),
    }.items():
        cs.store("dataset", name, {
            "name": name, "IN_CHANNEL": ch, "N_CLASSES": ncls,
            "IMG_SIZE": [size, size], "MU": mu, "STD": std,
        })
    cs.store("module/dynamics", "OrthoClassDynProjectSimplexLips", {
        "target": "SimplexDynamics",
        "n_hidden": "${dataset.N_CLASSES}", "activation": "ReLU",
        "dropout": 0.5, "mlp_size": 128, "kappa": 1.0, "kappa_length": 0,
        "alpha_1": 100.0, "alpha_2": 20.0, "sigma_1": 0.02,
        "scale_nominal": False, "x_dim": 10, "cayley": True,
    })
    for name in [
        "ORTHO_KWLarge_Concat", "ORTHO_KWLargeMNIST_Concat",
        "ORTHO_KWLarge_Concat_test", "ORTHO_KWLargeMNIST_Concat_test",
        "CIFAR_4C3F", "CIFAR_4C3F_nolips", "CIFAR_6C2F", "TinyMLP",
    ]:
        cs.store("module/init_fun/param_map", name, {
            "target": name, "mu": "${dataset.MU}", "std": "${dataset.STD}",
            "out_dim": 128, "act": "GroupSort",
        })
    for name in ["DefaultInitFun", "UniformInitFun"]:
        cs.store("module/init_fun", name, {
            "target": name, "h_dims": ["${dataset.N_CLASSES}"],
            "param_map": None,
        })
    cs.store("module/output", "Output", {"target": "default"})
    cs.store("module/output", "FirstNOutput",
             {"target": "first_n", "out_size": "${dataset.N_CLASSES}"})
    for name in ["MSELoss", "CompositeDynCrossEntropy", "DynCrossEntropy",
                 "OnemEtay", "DecisionBoundary"]:
        cs.store("module/lya_cand", name, {
            "target": name, "on_simplex": "${module.simplex}",
            "log_mode": False, "num_class": "${dataset.N_CLASSES}",
        })
    for name in ["UniformSimplexSampling", "BandSimplexSampling",
                 "ProjectedBiasedHyperSphereSampling",
                 "ProjectedHyperCubeSampling", "CorrectConeSampling",
                 "DecisionBoundarySampling", "TrajectorySampler"]:
        cs.store("module/sampler", name, {"target": name})
    cs.store("module/sampler", "CompositeSampler", {"target": "CompositeSampler"})
    cs.store("module/sampler_scheduler", "LinearScheduler", {
        "target": "LinearScheduler", "rate": 1.0, "bias": 0.0,
        "clamp": "min", "clamp_val": 0.0, "start": 0,
    })
    cs.store("module/sampler_scheduler", "ConstantScheduler",
             {"target": "ConstantScheduler", "constant": 1.0})
    cs.store("module/sampler_scheduler", "SwitchScheduler",
             {"target": "SwitchScheduler", "start": 0.0, "end": 1.0,
              "trigger": 1.0})
    cs.store("module/sampler_scheduler", "CompositeSamplerScheduler",
             {"target": "CompositeSamplerScheduler",
              "scheduler_weights": [1.0, 1.0]})
    general = {
        "decay_epochs": [30, 60, 90], "weight_decay": 0.0, "lr": 1e-3,
        "opt_name": "SGD", "momentum": 0.9, "beta1": 0.9, "beta2": 0.999,
        "scheduler_name": "cos_anneal", "max_epochs": 200, "warmup": 20,
        "adv_train": False, "eps": 0.5, "norm": "L2", "act": "relu",
        "fix_backbone": False, "val_adv": True,
    }
    ode = dict(general, **{
        "t_max": 1.0, "train_ode_solver": "dopri5", "train_ode_tol": 1e-7,
        "val_ode_solver": "dopri5", "val_ode_tol": 1e-7, "simplex": False,
        "n_output": "${dataset.N_CLASSES}",
    })
    cs.store("module", "ODEModule", dict(ode, target="ODELearning"))
    cs.store("module", "Lyapunov", dict(ode, **{
        "target": "LyapunovLearning", "order": 1, "h_sample_size": 128,
        "h_dist_lim": 30.0, "barrier_loss": False, "lips_train": False,
        "train_ode": False, "train_ode_epoch": 50,
        "relax_exp_stable": False, "scaleLeps": 3.0,
        "epoch_off_scale": 10, "lips_warmup": 0,
    }))
    cs.store("", "default", {
        "batch_size": 32, "val_batch_size": 32, "data_root": "data",
        "savedir": "run_data", "gpus": 1, "seed": 0, "disable_logs": False,
    })
    cs.store("", "certify", {
        "batch_size": 32, "val_batch_size": 32, "data_root": "data",
        "savedir": "run_data", "gpus": 1, "seed": 0, "disable_logs": False,
        "model_file": None, "norm": "2", "eps": 0.141, "kappa": 0.2,
        "T": 40, "batches": 10, "load_grid": False, "grid_name": "grid.pt",
        "start_ind": 0, "end_ind": 10000, "download": False,
    })


_register_defaults()


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def _set_path(cfg: dict, path: str, value):
    keys = path.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _get_path(cfg: dict, path: str):
    node = cfg
    for k in path.split("."):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node


def _deep_merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _apply_default(cfg: dict, entry):
    """One ``defaults:`` entry: {'group': 'Option'} or
    {'group@target.path': 'Option'} or a root name."""
    if isinstance(entry, str):
        entry = {"": entry}
    (key, option), = entry.items()
    if key == "_self_" or option is None:
        return
    if "@" in key:
        group, target = key.split("@", 1)
    else:
        group, target = key, key.replace("/", ".")
    node = ConfigStore.get(group, option)
    if target == "":
        _deep_merge(cfg, node)
        return
    cur = cfg
    keys = target.split(".")
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    if isinstance(cur.get(keys[-1]), dict):
        _deep_merge(cur[keys[-1]], node)
    else:
        cur[keys[-1]] = node


_INTERP = re.compile(r"^\$\{([^}]+)\}$")


def resolve(cfg: dict, root: Optional[dict] = None):
    """Resolve ${a.b.c} interpolations in place (repeated to a fixpoint)."""
    root = root if root is not None else cfg

    def walk(node):
        changed = False
        it = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in it:
            if isinstance(v, str):
                m = _INTERP.match(v)
                if m:
                    try:
                        node[k] = _get_path(root, m.group(1))
                        changed = True
                    except (KeyError, TypeError):
                        pass
            elif isinstance(v, (dict, list)):
                changed |= walk(v)
        return changed

    for _ in range(10):
        if not walk(cfg):
            break
    return cfg


_FLOATY = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _override_value(v: str):
    out = parse_value(v)
    # YAML 1.1 reads '1e-4' as a string; a CLI user means a float
    if isinstance(out, str) and _FLOATY.match(out):
        return float(out)
    return out


def parse_overrides(args: List[str]):
    """'a.b=v' (set), '+group=Option' (add a default), '++a.b=v' (force
    set); values are YAML scalars or flow collections."""
    sets, adds = [], []
    for a in args:
        if "=" not in a:
            raise ValueError(f"override {a!r} must be key=value")
        k, v = a.split("=", 1)
        if k.startswith("++"):
            sets.append((k[2:], _override_value(v)))
        elif k.startswith("+"):
            adds.append((k[1:], v))
        else:
            sets.append((k, _override_value(v)))
    return adds, sets


def compose(config_file: Optional[str] = None,
            overrides: Optional[List[str]] = None,
            config_dir: Optional[str] = None) -> dict:
    """A config from a YAML file's defaults, its body and the overrides."""
    cfg: dict = {}
    raw = {}
    if config_file:
        path = Path(config_dir or ".") / config_file
        if not path.suffix:
            path = path.with_suffix(".yaml")
        raw = load_yaml(path.read_text()) or {}
    adds, sets = parse_overrides(overrides or [])
    defaults = list(raw.pop("defaults", []))
    for group, option in adds:
        defaults.append({group: option})
    for entry in defaults:
        _apply_default(cfg, entry)
    _deep_merge(cfg, raw)
    for k, v in sets:
        _set_path(cfg, k, v)
    return resolve(cfg)
