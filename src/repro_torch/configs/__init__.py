"""One module per dense architecture the port serves (copies of
``repro.configs``' dense family).

Each exports CONFIG (the exact published configuration) and REDUCED (a
same-family scale-down that one CPU core can run in a test)."""
