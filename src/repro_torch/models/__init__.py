"""The LM side of the port — counterpart of ``repro/models``: the hybrid
RecurrentGemma family (``transformer``, ``layers``, ``rglru``) on the
``modules`` param trees, and the ``registry`` of ported configs."""
