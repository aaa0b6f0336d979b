"""Seconds of the scene pack in set-up (the Renderer's construction by the
Host), by the host clock, ended by a synchronise of the cards."""


def read(r):
    return r.pack_s
