"""Entry points of the port: step factories (``steps``) and the serving CLI
(``serve``)."""
