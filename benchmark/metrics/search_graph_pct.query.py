"""The share of the window's flat pq searches on the card that replayed a
captured CUDA graph, in %: the program's ``pq_search_graph`` over it and
``pq_search_eager`` (``ops/_launch.py``'s counts, differenced around the
window by the harness). None where neither moved: a program without the
counts, or a window with no pq search."""


def read(run):
    graph = run.launches.get("pq_search_graph", 0)
    eager = run.launches.get("pq_search_eager", 0)
    if not graph + eager:
        return None
    return 100.0 * graph / (graph + eager)
