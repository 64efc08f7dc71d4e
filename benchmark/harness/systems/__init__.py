"""The system under test of each likelihood kind, one module a kind
(``<likelihood>.py``), found by the configuration's ``likelihood`` key."""
