"""Shape buckets (``buckets.py``, a copy of the reference's). The
executable store and the compile-ahead lane are not ported: torch runs
eagerly and compiles nothing per program."""
