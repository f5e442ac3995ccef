"""One plain reference per address format, found by ``check.py`` as
``formats/<format>.py`` from the configuration's ``"format"``.  Each module
has ``derive_many(keys)``, the (address, WIF) of each key, or None where a
key has no address, and ``share(pattern)``, the exact share of addresses
the pattern matches, which raises ValueError where it has no closed form.
A cell of a new format needs only its module here."""
