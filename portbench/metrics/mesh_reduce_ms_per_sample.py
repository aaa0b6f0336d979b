"""Device ms a sample of the mesh's reduction: the copies from card to card
and the adds on the main card that the program launches outside its
stages and outside the benchmark's ``get_image`` range
(``parallel/mesh.py``: each shard's moments copied to the main card and
added there). The main card's adds outside stages also hold shard 0's two
luminance adds."""


def _cross_card_copy(o):
    return o.cat == "gpu_memcpy" and ("PtoP" in o.name or "DtoD" in o.name)


def read(r):
    t = r.trace
    if t is None or len(t.devices) < 2 or r.samples < 1:
        return None
    main = t.devices[0]
    us = [o.dur for o in t.ops
          if o.stage is None and o.own is None
          and (_cross_card_copy(o)
               or (o.device == main and o.cat == "kernel"
                   and "add" in o.name.lower()))]
    if not us:
        return None
    return sum(us) / 1e3 / r.samples
