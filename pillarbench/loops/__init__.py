"""Loops: each ``<loop>.py`` gives the ``Loop`` that a traffic file names
(see ``session.py`` for what a ``Loop`` does)."""
