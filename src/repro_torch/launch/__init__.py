"""Entry points of the port: step factories (``steps``), the serving CLI
(``serve``) and the LM training driver (``train``)."""
