"""One module a model family: how a cell of that family drives the
program, and how its plain reference is run on the same inputs."""
