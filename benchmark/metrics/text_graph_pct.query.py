"""The share of the window's text-tower forwards on the card that replayed
a captured CUDA graph, in %: the program's ``text_tower_graph`` over it and
``text_tower_eager`` (``ops/_launch.py``'s counts, differenced around the
window by the harness). None where neither moved: a program without the
counts, or a window with no text encode."""


def read(run):
    graph = run.launches.get("text_tower_graph", 0)
    eager = run.launches.get("text_tower_eager", 0)
    if not graph + eager:
        return None
    return 100.0 * graph / (graph + eager)
