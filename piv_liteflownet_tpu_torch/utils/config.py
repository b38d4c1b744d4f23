"""Flags reflected from signatures (port of ``piv_liteflownet_tpu/utils/config.py``).

``add_arguments_for_module`` adds ``--<group> <Name>`` over a registry of
classes or factories and one ``--<group>_<param>`` flag per parameter of any
of them; ``instance_from_args`` builds the chosen one from its flags. The
trainer's model, loss, optimizer, lr-scheduler, dataset and logger groups
are made so.
"""

from __future__ import annotations

import argparse
import inspect
from typing import Any, Dict, Mapping, Optional, Sequence


def module_to_dict(module, exclude=()) -> Dict[str, type]:
    """The public classes and functions of a module, by name."""
    out = {}
    for name in dir(module):
        obj = getattr(module, name)
        if (inspect.isclass(obj) or inspect.isfunction(obj)) and not name.startswith("_") \
                and obj not in exclude:
            out[name] = obj
    return out


def _add_flag(parser, arg_name: str, default: Any, explicit: bool = True) -> None:
    """Add one reflected flag.

    ``explicit=False`` means ``default`` is only the *union* default across the
    registry (used for type inference); the argparse default is then ``None``
    so an unset flag is omitted from ``kwargs_from_args`` and each factory
    applies its own signature default (``Lion``'s betas (0.9, 0.99) are not
    overridden by ``Adam``'s first-seen (0.9, 0.999)).
    """
    argparse_default = default if explicit else None
    if isinstance(default, bool):
        parser.add_argument(arg_name, type=lambda s: s.lower() in ("1", "true", "yes"),
                            default=argparse_default)
    elif isinstance(default, (list, tuple)):
        elem_t = type(default[0]) if len(default) else float
        parser.add_argument(arg_name, type=elem_t, nargs="+",
                            default=list(default) if explicit else None)
    elif default is None:
        parser.add_argument(arg_name, default=None)
    else:
        parser.add_argument(arg_name, type=type(default), default=argparse_default)


def add_arguments_for_module(
    parser: argparse.ArgumentParser,
    module_or_registry,
    argument_for_class: str,
    default: str,
    skip_params: Sequence[str] = (),
    parameter_defaults: Optional[Mapping[str, Any]] = None,
) -> None:
    """Add ``--<group> <ClassName>`` + ``--<group>_<param>`` flags.

    ``module_or_registry``: a module (classes found by reflection) or a dict
    name -> class/factory.
    """
    registry = (
        dict(module_or_registry)
        if isinstance(module_or_registry, Mapping)
        else module_to_dict(module_or_registry)
    )
    parser.add_argument(f"--{argument_for_class}", type=str, default=default,
                        choices=sorted(registry.keys()))
    parameter_defaults = dict(parameter_defaults or {})

    # union of params over registry entries so any class is configurable
    seen: Dict[str, Any] = {}
    for cls in registry.values():
        fn = cls.__init__ if inspect.isclass(cls) else cls
        try:
            sig = inspect.signature(fn)
        except (TypeError, ValueError):
            continue
        for pname, p in sig.parameters.items():
            if pname in ("self",) or pname in skip_params or p.kind in (
                inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD,
            ):
                continue
            default_val = parameter_defaults.get(
                pname, None if p.default is inspect.Parameter.empty else p.default
            )
            if pname not in seen:
                seen[pname] = default_val
    for pname, dval in seen.items():
        # caller-supplied parameter_defaults are real group defaults; union
        # (first-seen) factory defaults are type hints only — the selected
        # factory resolves its own default when the flag is unset.
        _add_flag(parser, f"--{argument_for_class}_{pname}", dval,
                  explicit=pname in parameter_defaults)

    setattr(parser, f"_{argument_for_class}_registry", registry)


def kwargs_from_args(args: argparse.Namespace, prefix: str, skip=()) -> Dict[str, Any]:
    """``{param: value}`` of the set ``--<prefix>_<param>`` flags."""
    pre = prefix + "_"
    return {
        k[len(pre):]: v
        for k, v in vars(args).items()
        if k.startswith(pre) and k[len(pre):] not in skip and v is not None
    }


def instance_from_args(parser, args, prefix: str, registry=None, extra_kwargs=None, skip=()):
    """Instantiate the class selected by ``--<prefix>`` with its group flags."""
    registry = registry or getattr(parser, f"_{prefix}_registry")
    cls = registry[getattr(args, prefix)]
    fn = cls.__init__ if inspect.isclass(cls) else cls
    accepted = set(inspect.signature(fn).parameters)
    kwargs = {k: v for k, v in kwargs_from_args(args, prefix, skip).items() if k in accepted}
    kwargs.update(extra_kwargs or {})
    return cls(**kwargs)
