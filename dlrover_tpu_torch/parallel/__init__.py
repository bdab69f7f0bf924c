"""Parallelism: the mesh's rule tables, the data group's wire, the
(int8) collectives and the overlap engine's bucket plan."""
