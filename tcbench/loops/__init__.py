"""One traffic loop a file, named by a mix's ``"loop"`` key, each with
``measure(mix, make_graph, options, device, seconds, trace) -> Window``
(``tcbench.loop``). ``make_graph(variant)`` returns the host ``Graph`` of
one variant of the cell's input; variant 0 is the seed's own graph."""
