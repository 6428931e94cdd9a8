"""``mx.viz``: network visualization.

Counterpart of ``mxnet_tpu/visualization.py`` (MXNet's
``python/mxnet/visualization.py``): ``print_summary`` prints the layer
table (shapes through ``Symbol.infer_shape``); ``plot_network`` returns
graphviz DOT source as a string, where MXNet returns a
``graphviz.Digraph``."""
from __future__ import annotations

from typing import Dict, Optional

from .base import MXNetError

__all__ = ["print_summary", "plot_network"]


def _walk(symbol):
    """The nodes of a Symbol DAG in topological order."""
    from .symbol import _postorder

    return _postorder([symbol])


def print_summary(symbol, shape: Optional[Dict[str, tuple]] = None, line_length=100):
    """Print a Keras-style layer table; returns total parameter count."""
    shapes = {}
    if shape:
        inferred = symbol.infer_shape(**shape)
        if inferred is not None:
            arg_shapes, _, _ = inferred
            shapes = dict(zip(symbol.list_arguments(), arg_shapes))
    header = f"{'Layer (type)':<40}{'Output/Shape':<30}{'Params':<12}Inputs"
    print("=" * line_length)
    print(header)
    print("=" * line_length)
    total = 0
    for node in _walk(symbol):
        if node._op is None:
            shp = shapes.get(node._name)
            n_par = 0
            if shp and not node._name.endswith(("data", "label")):
                n_par = 1
                for d in shp:
                    n_par *= int(d)
            total += n_par
            print(f"{node._name + ' (var)':<40}{str(shp or '?'):<30}{n_par:<12}")
        else:
            ins = ", ".join(i._name for i in node._inputs)
            print(f"{node._name + f' ({node._op})':<40}{'':<30}{'':<12}{ins}")
    print("=" * line_length)
    print(f"Total params: {total}")
    return total


def plot_network(symbol, title="plot", shape=None, node_attrs=None, save_format="dot"):
    """Return graphviz DOT source for the Symbol graph."""
    if symbol is None:
        raise MXNetError("plot_network requires a Symbol")
    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    for node in _walk(symbol):
        nid = f"n{id(node) % 10 ** 8}"
        if node._op is None:
            lines.append(f'  {nid} [label="{node._name}" shape=oval '
                         f'fillcolor="#8dd3c7" style=filled];')
        else:
            lines.append(f'  {nid} [label="{node._name}\\n{node._op}" shape=box '
                         f'fillcolor="#80b1d3" style=filled];')
        for i in node._inputs:
            lines.append(f"  n{id(i) % 10 ** 8} -> {nid};")
    lines.append("}")
    return "\n".join(lines)
