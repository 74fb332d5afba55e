"""The weight layout of each family, found by the config's ``arch_type``.

``<arch_type>.py`` defines ``groups(cfg) -> List[weights.Group]``: the
whole parameter tree of the port's ``Model`` for that family, in order,
as groups of a key prefix, a row count (None, or the stack's own length)
and ``(key, shape, kind, std)`` leaves.  :mod:`servebench.weights` draws
every slice from its seed by the rule in its docstring.
"""
