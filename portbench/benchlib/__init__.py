"""The benchmark's general machinery: finding a cell's files by name
(``layout``), one run with its window and checks (``cell``), the program's
side of a cell (``port``), the per-answer comparisons (``compare``), the
profiler trace's reading (``trace``) and the roofline arithmetic
(``roofline``)."""
