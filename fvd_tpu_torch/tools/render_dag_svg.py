"""Render the 16-node analysis DAG to a static SVG:

    python -m fvd_tpu_torch.tools.render_dag_svg [--out dag.svg]

The counterpart of the JAX package's ``tools/render_dag_svg.py``: the
diagram comes straight from the live graph definition
(:func:`fvd_tpu_torch.graph.build_graph`, wiring only, no model loads), so
it cannot drift from the wiring.  Layout matches the web UI's: topological
depth gives the column, insertion order the row.  The SVG equals the JAX
tool's byte for byte.  ``--out`` defaults to ``dag.svg`` in the working
directory.  Drawing touches no device, so the tool takes no ``--cpu``:
the wiring-only graph is built for the CPU and runs anywhere.
"""

from __future__ import annotations

import argparse


def render_svg() -> str:
    """The SVG text of the DAG's nodes and edges."""
    from fvd_tpu_torch.graph import build_graph
    from fvd_tpu_torch.providers import Providers

    dag = build_graph(providers=Providers(), device="cpu")  # wiring only; no model loads
    depth = {}
    for name in dag.topological_order():
        deps = dag.nodes[name].deps
        depth[name] = 1 + max((depth[d] for d in deps), default=-1)
    cols: dict = {}
    for n, d in depth.items():
        cols.setdefault(d, []).append(n)
    pos = {}
    for d, nodes in cols.items():
        for i, n in enumerate(nodes):
            pos[n] = (90 + d * 130, 50 + i * 62)

    w = 90 + (max(cols) + 1) * 130
    h = 50 + max(len(v) for v in cols.values()) * 62 + 20
    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'font-family="sans-serif">',
        '<defs><marker id="arr" markerWidth="8" markerHeight="8" refX="7" '
        'refY="3" orient="auto"><path d="M0,0 L7,3 L0,6" fill="none" '
        'stroke="#666"/></marker></defs>',
        f'<rect width="{w}" height="{h}" fill="#161616"/>',
    ]
    for src, dst in dag.edges():
        (ax, ay), (bx, by) = pos[src], pos[dst]
        parts.append(
            f'<path d="M {ax + 28} {ay} C {(ax + bx) / 2} {ay}, '
            f'{(ax + bx) / 2} {by}, {bx - 30} {by}" fill="none" '
            'stroke="#666" stroke-width="1.2" marker-end="url(#arr)"/>')
    for name, (x, y) in pos.items():
        parts.append(f'<ellipse cx="{x}" cy="{y}" rx="28" ry="18" '
                     'fill="#2a4a7a" stroke="#69c"/>')
        parts.append(f'<text x="{x}" y="{y + 4}" fill="#fff" font-size="12" '
                     f'text-anchor="middle">{name}</text>')
    parts.append("</svg>")
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="dag.svg")
    args = ap.parse_args(argv)
    svg = render_svg()
    with open(args.out, "w") as f:
        f.write(svg)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
