"""Graph debugging helpers.

Counterpart of ``pygmu2_tpu.utils.debug`` (reference:
src/pygmu2/debug_utils.py:13-70): pretty-print a PE tree with shared-node
and cycle detection, plus a summary of the graph and its cached render
programs. A graph built the same way in both packages prints the same
tree wherever the PEs' reprs agree.
"""

from __future__ import annotations

from pygmu2_tpu_torch.core.processing_element import ProcessingElement


def print_pe_tree(root: ProcessingElement, max_depth: int = 32) -> None:
    """Print the graph rooted at ``root`` as an indented tree.

    Shared nodes (pure fan-out) are annotated; cycles are cut with a
    marker rather than recursing forever.
    """
    print(format_pe_tree(root, max_depth=max_depth))


def format_pe_tree(root: ProcessingElement, max_depth: int = 32) -> str:
    seen: dict[int, int] = {}
    lines: list[str] = []

    def label(pe: ProcessingElement) -> str:
        ext = pe.extent()
        purity = "pure" if pe.is_pure() else "stateful"
        ch = pe.channel_count()
        ch_str = "?" if ch is None else str(ch)
        return f"{pe!r}  [{purity}, ch={ch_str}, extent={ext!r}]"

    def walk(pe: ProcessingElement, depth: int, stack: set[int]) -> None:
        indent = "  " * depth
        if id(pe) in stack:
            lines.append(f"{indent}<cycle: {type(pe).__name__}>")
            return
        if id(pe) in seen:
            lines.append(f"{indent}<shared: {type(pe).__name__} #{seen[id(pe)]}>")
            return
        seen[id(pe)] = len(seen)
        lines.append(f"{indent}{label(pe)}")
        if depth >= max_depth:
            lines.append(f"{indent}  <max depth reached>")
            return
        for inp in pe.inputs():
            walk(inp, depth + 1, stack | {id(pe)})

    walk(root, 0, set())
    return "\n".join(lines)


def graph_stats(root: ProcessingElement) -> dict:
    """Node counts and compiled-program inventory for the graph."""
    from pygmu2_tpu_torch.core import engine

    nodes = engine._walk(root)
    programs = getattr(root, "_programs", {})
    return {
        "n_nodes": len(nodes),
        "n_pure": sum(1 for n in nodes if n.is_pure()),
        "n_stateful": sum(1 for n in nodes if not n.is_pure()),
        "compiled_block_sizes": sorted({duration for duration, _device in programs}),
        "node_types": sorted({type(n).__name__ for n in nodes}),
    }
