"""Launchers — counterpart of ``repro/launch``: ``serve``, the LM serving
entry point (batched greedy decode against the cache)."""
