"""Command lines of the port: one module for each of ``README.md``'s
sixteen ``scripts/<name>.py`` entry points, under the script's own name.

    python -m mptpu_torch.scripts.<name> [the script's flags] [--device cpu]

Each module's ``build_parser()`` takes exactly the script's flags (option
strings, destinations, defaults, types, choices, ``nargs``, actions and
help) and one of its own, ``--device`` (default ``cuda``; ``cpu`` runs on
the CPU, and without CUDA the default raises). Its ``main(argv)`` is the
script's ``__main__``: the ``--tiny`` overrides, the dispatch between modes,
the default paths (relative to the working directory), ``--watchdog-s``
(``faulthandler.dump_traceback_later``), the printed lines and the files
written, over the function of ``mptpu_torch.models`` that does the
script's work.
"""
