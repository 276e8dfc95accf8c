"""The plain references, one module per kind of answer (see ``triangles``)."""
