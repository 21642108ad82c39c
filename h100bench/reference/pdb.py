"""Plain reader of the PDB text the serving mixes send: ATOM and HETATM
records by their fixed columns, without water and hydrogens, residues
numbered in order of appearance (a new residue where the chain, the
residue number or the insertion code changes), as the published
clean-up does."""

import numpy as np


def read(text: bytes) -> dict:
    name, resname, element, xyz, key = [], [], [], [], []
    for raw in text.decode().splitlines():
        if raw[:6] not in ("ATOM  ", "HETATM") or len(raw) < 54:
            continue
        rn, el = raw[17:20].strip(), raw[76:78].strip() if len(raw) >= 78 else ""
        if rn in ("HOH", "DOD") or el in ("H", "D"):
            continue
        name.append(raw[12:16].strip())
        resname.append(rn)
        element.append(el[:1].upper() + el[1:].lower())
        xyz.append((float(raw[30:38]), float(raw[38:46]), float(raw[46:54])))
        key.append((raw[21], raw[22:26], raw[26]))
    new = np.array([i == 0 or key[i] != key[i - 1] for i in range(len(key))])
    return {"xyz": np.array(xyz, np.float32), "name": np.array(name), "resname": np.array(resname),
            "element": np.array(element), "resid": np.cumsum(new)}
