"""``batch_p95_ms`` where the card idles most of the window and the host
sets the tail: the same reader."""

from lartpcbench.metrics import reader

read = reader("batch_p95_ms")
