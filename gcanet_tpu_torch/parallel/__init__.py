"""Data parallelism of the port: process groups and cross-process helpers
(``dist``), and the in-process chunks of a batch served over a list of
devices (``chunks``)."""
