"""YAML via libyaml's C loader and dumper when available (the port of
``chunky_bits_tpu/utils/yamlio.py``).

PyYAML is imported inside the functions, not with the module, so the
compute plane imports without it; the cluster and the CLI need it for
their YAML files.  Semantics are
``yaml.safe_load``/``yaml.safe_dump``; the pure-Python classes stand in
when PyYAML was built without libyaml.
"""

from __future__ import annotations


def yaml_load(data):
    """``yaml.safe_load`` semantics, C-accelerated."""
    import yaml

    return yaml.load(data, Loader=getattr(yaml, "CSafeLoader",
                                          yaml.SafeLoader))


def yaml_dump(obj, stream=None, **kwargs):
    """``yaml.safe_dump`` semantics, C-accelerated; block style by
    default, so the output is byte-identical to ``yaml.safe_dump``'s."""
    import yaml

    kwargs.setdefault("default_flow_style", False)
    return yaml.dump(obj, stream, Dumper=getattr(yaml, "CSafeDumper",
                                                 yaml.SafeDumper), **kwargs)
