"""Adapters from the generator's plain inputs to the program's provers,
one module a prover, named by a configuration's ``prover``.  Each gives
``program_input(inp)``, ``prove(program_input, pp, device, timer)``,
``to_bytes(proof)`` and ``columns(inp)`` (the reference's columns of the
input).  They import the program inside their functions."""
