"""Frontends: the terminal status UI (``app.py``) and the web UI (``web.py``)."""
