"""Multi-device proving over a row mesh of torch devices (the JAX
package's parallel/): `mesh` (the mesh, `place_rows`, `RowSharded`),
`collectives` (explicit device-to-device collectives and their byte
counts) and `sharded` (the 4-step NTT, the sharded LDE and Merkle commit,
LogUp offsets, the demo step)."""
