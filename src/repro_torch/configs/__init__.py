"""One module per architecture the port serves (copies of
``repro.configs``' ten architectures).

Each exports CONFIG (the exact published configuration) and REDUCED (a
same-family scale-down that one CPU core can run in a test)."""
