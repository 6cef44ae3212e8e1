"""Host seconds of the program's scene construction: the loader's parse
and tables, the BVH, treelets, chunks and slot budgets, on the card."""


def read(r):
    return r["scene_build_s"]
