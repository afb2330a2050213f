"""The benchmark's input generators: frozen copies of the program's
own (see PERF.md for where each was taken from). They build the
program's public data types as inputs to its entry points; the
reference never reads what they derive."""
