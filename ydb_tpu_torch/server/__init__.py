"""The worker surface of the port's server (``server/service.py``)."""
