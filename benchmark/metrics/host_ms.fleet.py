"""``host_ms.fleet``: host milliseconds per request of the program's spans
``serve.decode`` (body read, ``json.loads``) and ``serve.encode`` (the
arrays to lists, ``json.dumps``, the write) in the traced window
(``serve.make_http_server``'s POST path)."""

from benchmark.common import spans


def read(run):
    return spans.host_ms(["serve.decode", "serve.encode"],
                         per="serve.decode")
