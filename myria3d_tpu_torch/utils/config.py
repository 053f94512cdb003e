"""Hydra-style YAML configuration system (self-contained, no hydra dependency).

Re-implements the subset of Hydra 1.1 + OmegaConf semantics that the reference
relies on (reference ``configs/config.yaml:25-42``, ``run.py:41-105``,
``__init__.py:1-6``):

- config *groups* as directories, composed through ``defaults:`` lists
  (including ``_self_``, relative/absolute group paths, and
  ``override /group/path: choice`` entries used by experiment overlays);
- ``# @package _global_`` overlays merged at the config root;
- ``${a.b.c}`` interpolation plus the resolvers the reference uses:
  ``${oc.env:VAR[,default]}``, ``${oc.dict.values: path}``,
  ``${get_method:dotted.path}``, ``${hydra:runtime.cwd}``, ``${now:%fmt}``;
- dotted command-line value overrides (``a.b=3``) and group choice overrides
  (``experiment=predict``, ``model/lr_scheduler=OneCycleLR``);
- ``instantiate()`` of ``_target_`` nodes with ``_args_`` positional args,
  recursive instantiation, and ``functools.partial`` late binding.

Composition is eager; interpolations are resolved after composition with cycle
detection. ``${get_method:...}`` and ``${oc.env:...}`` are resolved lazily at
instantiation/access time so that configs mentioning unset env vars can still
be composed (Hydra behaves the same way).

Copied from ``myria3d_tpu/utils/config.py``; imports point at the port.
"""

from __future__ import annotations

import copy
import datetime
import importlib
import os
import re
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import yaml

__all__ = [
    "DotDict",
    "compose",
    "instantiate",
    "get_method",
    "to_yaml",
    "save_config",
    "load_config",
    "merge",
    "select",
    "update",
]


class ConfigError(Exception):
    pass


class DotDict(dict):
    """dict with attribute access and recursive wrapping (DictConfig-lite)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key: str, default: Any = None) -> Any:
        # Dotted access in get(), mirroring OmegaConf.select convenience.
        if "." in key:
            return select(self, key, default)
        return super().get(key, default)

    @staticmethod
    def wrap(obj: Any) -> Any:
        if isinstance(obj, dict) and not isinstance(obj, DotDict):
            return DotDict({k: DotDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, DotDict):
            for k, v in obj.items():
                obj[k] = DotDict.wrap(v)
            return obj
        if isinstance(obj, list):
            return [DotDict.wrap(v) for v in obj]
        return obj


def merge(base: dict, overlay: dict) -> dict:
    """Deep-merge ``overlay`` into ``base`` (in place); dicts merge, scalars/lists replace."""
    for key, value in overlay.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            merge(base[key], value)
        else:
            base[key] = copy.deepcopy(value)
    return base


def select(cfg: dict, dotted: str, default: Any = None) -> Any:
    node: Any = cfg
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            return default
    return node


def update(cfg: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    node = cfg
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            node[part] = DotDict()
        node = node[part]
    node[parts[-1]] = value


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

_GLOBAL_PACKAGE_RE = re.compile(r"^#\s*@package\s+_global_\s*$", re.M)


def _load_yaml_file(path: str) -> Tuple[dict, bool]:
    """Returns (content, is_global_package)."""
    with open(path, "r") as f:
        text = f.read()
    is_global = bool(_GLOBAL_PACKAGE_RE.search(text.split("\n\n")[0])) or bool(
        _GLOBAL_PACKAGE_RE.search(text[:200])
    )
    content = yaml.safe_load(text)
    if content is None:
        content = {}
    if not isinstance(content, dict):
        raise ConfigError(f"Config file {path} must contain a mapping, got {type(content)}")
    return content, is_global


def _find_config_file(config_dir: str, group: str, name: str) -> Optional[str]:
    name = name if name.endswith((".yaml", ".yml")) else name + ".yaml"
    path = os.path.join(config_dir, group, name) if group else os.path.join(config_dir, name)
    return path if os.path.isfile(path) else None


def _parse_defaults_entry(entry: Any) -> Tuple[bool, bool, str, Optional[str]]:
    """Parse one defaults-list entry -> (is_self, is_override, group, choice)."""
    if entry == "_self_":
        return True, False, "", None
    if isinstance(entry, str):
        # bare file include, e.g. "- default.yaml" inside a group dir
        return False, False, "", entry
    if isinstance(entry, dict) and len(entry) == 1:
        key, choice = next(iter(entry.items()))
        key = str(key).strip()
        is_override = key.startswith("override")
        if is_override:
            key = key[len("override"):].strip()
        # Ignore hydra-INTERNAL groups (logging plugins); the plain `hydra`
        # group itself IS composed — it carries run.dir, which run.py uses
        # to reproduce hydra's per-run working directory.
        if key.lstrip("/").startswith("hydra/"):
            return False, True, "__ignore__", None
        return False, is_override, key, None if choice is None else str(choice)
    raise ConfigError(f"Cannot parse defaults entry: {entry!r}")


class _Composer:
    def __init__(self, config_dir: str, choice_overrides: Dict[str, str]):
        self.config_dir = config_dir
        # group path (no leading slash) -> chosen config name
        self.choice_overrides = dict(choice_overrides)

    def resolve_group(self, current_group: str, group_key: str) -> str:
        if group_key.startswith("/"):
            return group_key.lstrip("/")
        return f"{current_group}/{group_key}" if current_group else group_key

    def compose_file(self, group: str, name: str, root: dict) -> None:
        """Compose config file ``group/name`` into ``root`` (mutates root)."""
        path = _find_config_file(self.config_dir, group, name)
        if path is None:
            raise ConfigError(
                f"Config file not found: group='{group}' name='{name}' under {self.config_dir}"
            )
        content, is_global = _load_yaml_file(path)
        defaults = content.pop("defaults", None)

        own: dict = content

        def merge_own() -> None:
            if is_global or group == "":
                merge(root, own)
            else:
                target = root
                for part in group.split("/"):
                    target = target.setdefault(part, {})
                merge(target, own)

        if defaults is None:
            merge_own()
            return

        saw_self = any(e == "_self_" for e in defaults)
        if not saw_self:
            # Hydra 1.1: _self_ implicitly last (own content overrides defaults).
            defaults = list(defaults) + ["_self_"]

        for entry in defaults:
            is_self, is_override, sub_group, choice = _parse_defaults_entry(entry)
            if is_self:
                merge_own()
                continue
            if sub_group == "__ignore__":
                continue
            if is_override:
                # Override entries change choices for groups composed elsewhere;
                # they are collected in a pre-scan pass (see compose()).
                continue
            if sub_group == "" and choice is not None:
                # bare include relative to current group dir
                self.compose_file(group, choice, root)
                continue
            full_group = self.resolve_group(group, sub_group)
            chosen = self.choice_overrides.get(full_group, choice)
            if chosen is None or str(chosen).lower() in ("null", "none"):
                continue
            self.compose_file(full_group, chosen, root)

    def scan_overrides(
        self, group: str, name: str, _seen: Optional[set] = None
    ) -> Dict[str, str]:
        """Collect ``override /group: choice`` entries from a config file's
        defaults, recursing into bare file includes (an experiment layered on
        another experiment inherits its overrides; the including file's own
        entries win)."""
        path = _find_config_file(self.config_dir, group, name)
        if path is None:
            return {}
        _seen = _seen if _seen is not None else set()
        if path in _seen:
            return {}
        _seen.add(path)
        content, _ = _load_yaml_file(path)
        found: Dict[str, str] = {}
        for entry in content.get("defaults", []) or []:
            is_self, is_override, sub_group, choice = _parse_defaults_entry(entry)
            if is_self or choice is None:
                continue
            if is_override and sub_group not in ("", "__ignore__"):
                found[self.resolve_group(group, sub_group)] = choice
            elif not is_override and sub_group == "":
                # bare include within the same group: inherit its overrides
                for k, v in self.scan_overrides(group, choice, _seen).items():
                    found.setdefault(k, v)
        return found


def _parse_override_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def split_overrides(
    config_dir: str, overrides: List[str]
) -> Tuple[Dict[str, str], List[Tuple[str, Any]]]:
    """Split CLI overrides into (group choices, dotted value overrides)."""
    group_choices: Dict[str, str] = {}
    value_overrides: List[Tuple[str, Any]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"Override '{ov}' must be of the form key=value")
        key, _, raw = ov.partition("=")
        key = key.strip()
        if "." not in key and os.path.isdir(os.path.join(config_dir, key.replace("/", os.sep))):
            group_choices[key] = raw.strip()
        else:
            value_overrides.append((key, _parse_override_value(raw)))
    return group_choices, value_overrides


def compose(
    config_dir: str = "configs",
    config_name: str = "config.yaml",
    overrides: Optional[List[str]] = None,
    resolve: bool = True,
) -> DotDict:
    """Compose a config from a Hydra-style config tree.

    Args:
        config_dir: root directory of the config tree.
        config_name: root config file name.
        overrides: CLI-style overrides (``a.b=v`` values, ``group=choice`` swaps).
        resolve: eagerly resolve ``${...}`` interpolations.
    """
    overrides = list(overrides or [])
    group_choices, value_overrides = split_overrides(config_dir, overrides)

    # Pre-scan pass: find the chosen experiment overlay (if any) and collect its
    # `override /group: choice` entries so they affect groups composed earlier.
    pre = _Composer(config_dir, group_choices)
    root_path = _find_config_file(config_dir, "", config_name)
    if root_path is None:
        raise ConfigError(f"Root config {config_name} not found under {config_dir}")
    root_content, _ = _load_yaml_file(root_path)
    scanned: Dict[str, str] = {}
    for entry in root_content.get("defaults", []) or []:
        is_self, is_override, group, choice = _parse_defaults_entry(entry)
        if is_self or is_override or group in ("", "__ignore__"):
            continue
        chosen = group_choices.get(group, choice)
        if chosen is None:
            continue
        scanned.update(pre.scan_overrides(group, chosen))
    # CLI group choices take precedence over experiment-declared overrides.
    final_choices = {**scanned, **group_choices}

    composer = _Composer(config_dir, final_choices)
    cfg: dict = {}
    composer.compose_file("", config_name, cfg)

    for key, value in value_overrides:
        update(cfg, key, value)

    cfg = DotDict.wrap(cfg)
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")

# Resolvers kept lazy (left as strings during resolution; consumed by
# instantiate() / get_method()).
_LAZY_PREFIXES = ("get_method:",)


def _resolve_expr(expr: str, root: dict, stack: Tuple[str, ...]) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        body = expr[len("oc.env:"):]
        if "," in body:
            var, default = body.split(",", 1)
            return os.environ.get(var.strip(), default.strip())
        var = body.strip()
        if var not in os.environ:
            raise ConfigError(f"Environment variable '{var}' is not set (needed by ${{{expr}}})")
        return os.environ[var]
    if expr.startswith("oc.dict.values:"):
        path = expr[len("oc.dict.values:"):].strip()
        node = select(root, path)
        if node is None:
            return []
        if not isinstance(node, dict):
            raise ConfigError(f"oc.dict.values target '{path}' is not a dict")
        return [
            _resolve_value(v, root, stack + (path,))
            for k, v in node.items()
            if v is not None
        ]
    if expr.startswith("hydra:"):
        what = expr[len("hydra:"):].strip()
        if what == "runtime.cwd":
            # the ORIGINAL invocation cwd even after run.py chdirs into
            # hydra.run.dir (hydra semantics; run.py freezes it at startup)
            return _runtime_info.get("runtime_cwd", os.getcwd())
        if what == "run.dir":
            # Prefer the composed hydra.run.dir (reference logger/csv.yaml
            # targets ${hydra:run.dir}); absolute so consumers resolved
            # before run.py chdirs into it still point at the same place.
            node = select(root, "hydra.run.dir")
            if node is not None:
                return os.path.abspath(
                    str(_resolve_value(node, root, stack + ("hydra.run.dir",)))
                )
            return _runtime_info.get("run_dir", os.getcwd())
        return ""
    if expr.startswith("now:"):
        # One timestamp per resolve pass: hydra.run.dir is interpolated
        # both for its own node and via ${hydra:run.dir} consumers — a
        # per-call datetime.now() could straddle a second boundary and
        # yield two different run dirs in one composed config.
        fmt = expr[len("now:"):]
        if _NOW_CACHE is not None:
            ts = _NOW_CACHE.setdefault("ts", datetime.datetime.now())
        else:
            ts = datetime.datetime.now()
        return ts.strftime(fmt)
    if any(expr.startswith(p) for p in _LAZY_PREFIXES):
        return "${" + expr + "}"  # keep lazy
    # plain config path
    if expr in stack:
        raise ConfigError(f"Interpolation cycle detected at '{expr}'")
    node = select(root, expr, default=ConfigError)
    if node is ConfigError:
        raise ConfigError(f"Interpolation key '{expr}' not found")
    return _resolve_value(node, root, stack + (expr,))


def _resolve_value(value: Any, root: dict, stack: Tuple[str, ...] = ()) -> Any:
    if isinstance(value, str):
        full = _INTERP_RE.fullmatch(value.strip())
        if full:
            return _resolve_expr(full.group(1), root, stack)

        def repl(m: "re.Match[str]") -> str:
            resolved = _resolve_expr(m.group(1), root, stack)
            return str(resolved)

        return _INTERP_RE.sub(repl, value)
    if isinstance(value, dict):
        return DotDict({k: _resolve_value(v, root, stack) for k, v in value.items()})
    if isinstance(value, list):
        return [_resolve_value(v, root, stack) for v in value]
    return value


_runtime_info: Dict[str, str] = {}


def set_runtime_info(**kwargs: str) -> None:
    """Set runtime values available via ``${hydra:...}`` (e.g. run_dir)."""
    _runtime_info.update(kwargs)


_NOW_CACHE: Optional[Dict[str, Any]] = None


def resolve_interpolations(cfg: DotDict) -> DotDict:
    global _NOW_CACHE
    _NOW_CACHE = {}
    try:
        return _resolve_value(cfg, cfg)  # type: ignore[return-value]
    finally:
        _NOW_CACHE = None


# ---------------------------------------------------------------------------
# Instantiation
# ---------------------------------------------------------------------------

def get_method(dotted: str) -> Any:
    """Import a function/class from a dotted path (the `get_method` resolver,
    reference repo-root ``__init__.py:1-6``)."""
    dotted = dotted.strip()
    m = _INTERP_RE.fullmatch(dotted)
    if m and m.group(1).strip().startswith("get_method:"):
        dotted = m.group(1).strip()[len("get_method:"):].strip()
    module_path, _, attr = dotted.rpartition(".")
    if not module_path:
        raise ConfigError(f"Cannot import '{dotted}': not a dotted path")
    try:
        module = importlib.import_module(module_path)
        return getattr(module, attr)
    except (ImportError, AttributeError):
        # Maybe the attr is nested (module.Class.method)
        parts = dotted.split(".")
        for i in range(len(parts) - 1, 0, -1):
            try:
                module = importlib.import_module(".".join(parts[:i]))
            except ImportError:
                continue
            obj: Any = module
            try:
                for attr_name in parts[i:]:
                    obj = getattr(obj, attr_name)
                return obj
            except AttributeError:
                continue
        raise ConfigError(f"Cannot import '{dotted}'")


_SPECIAL_KEYS = ("_target_", "_args_", "_convert_", "_partial_", "_recursive_")


def instantiate(node: Any, *extra_args: Any, **extra_kwargs: Any) -> Any:
    """Recursively instantiate ``_target_`` nodes (hydra.utils.instantiate-lite)."""
    if node is None:
        return None
    if isinstance(node, str):
        s = node.strip()
        m = _INTERP_RE.fullmatch(s)
        if m and m.group(1).strip().startswith("get_method:"):
            return get_method(s)
        return node
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return DotDict({k: instantiate(v) for k, v in node.items()})

    target_name = str(node["_target_"])
    target = get_method(target_name)
    args = [instantiate(a) for a in node.get("_args_", [])]
    kwargs = {
        k: instantiate(v) for k, v in node.items() if k not in _SPECIAL_KEYS
    }
    kwargs.update(extra_kwargs)
    args = args + list(extra_args)

    is_partial = bool(node.get("_partial_", False)) or target is partial
    if target is partial:
        if not args:
            raise ConfigError("functools.partial target requires a callable first argument")
        fn, rest = args[0], args[1:]
        return partial(fn, *rest, **kwargs)
    if is_partial:
        return partial(target, *args, **kwargs)
    return target(*args, **kwargs)


# ---------------------------------------------------------------------------
# Serialization
# ---------------------------------------------------------------------------

def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_plain(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def to_yaml(cfg: dict) -> str:
    return yaml.safe_dump(_to_plain(cfg), sort_keys=False, default_flow_style=False)


def save_config(cfg: dict, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


def load_config(path: str, resolve: bool = True) -> DotDict:
    """Load a single fully-composed config file (e.g. a frozen predict config)."""
    with open(path, "r") as f:
        cfg = DotDict.wrap(yaml.safe_load(f) or {})
    cfg.pop("defaults", None)
    if resolve:
        cfg = resolve_interpolations(cfg)
    return cfg
