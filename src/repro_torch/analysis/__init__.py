"""Runtime analysis of the port's engines: the sanitizers
(``repro_torch.analysis.sanitize``).  The static checker, cascade-lint,
is stdlib tooling that scans the whole tree (the port included) and is
not ported."""
