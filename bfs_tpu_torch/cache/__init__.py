"""Persistent artifact caches of the port (:mod:`.layout`: the layout
bundles)."""
