"""One configuration a pair of files: ``<name>.json`` (the sizes as run)
and ``<name>.py`` (``program_scene`` through the program's entry,
``reference_scene`` built again from the description alone)."""
