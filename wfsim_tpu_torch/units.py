"""Coherent unit system for wfsim_tpu_torch (same values as wfsim_tpu/units.py).

Base units: distances in cm, times in ns, energies in eV, charge in number of
electrons, temperature in K.  This mirrors the unit conventions of the
reference simulator (reference: wfsim/units.py) so that configuration values
are interchangeable; the constants are standard CODATA values.
"""

electron_charge_SI = 1.602176565e-19  # C
boltzmannConstant_SI = 1.3806488e-23  # J/K

# Base units
m = 1e2        # distances in cm
s = 1e9        # times in ns
eV = 1.0       # energies in eV
C = 1.0 / electron_charge_SI  # charge in number of electrons
K = 1.0        # temperature in K

# Derived units
Hz = 1 / s
J = eV / electron_charge_SI
kg = J * s ** 2 / m ** 2
V = J / C
A = C / s
N = J / m
Pa = N / m ** 2
bar = 1e5 * Pa
Ohm = V / A

cm = 1e-2 * m
mm = 1e-3 * m
um = 1e-6 * m
nm = 1e-9 * m
km = 1e3 * m

ms = 1e-3 * s
us = 1e-6 * s
ns = 1e-9 * s

keV = 1e3 * eV
MeV = 1e6 * eV
GeV = 1e9 * eV
meV = 1e-3 * eV

kV = 1e3 * V
MV = 1e6 * V
mV = 1e-3 * V
uV = 1e-6 * V

kHz = 1e3 * Hz
MHz = 1e6 * Hz
GHz = 1e9 * Hz
mHz = 1e-3 * Hz

g = 1e-3 * kg
mg = 1e-6 * kg
ug = 1e-9 * kg
ng = 1e-12 * kg

mA = 1e-3 * A
uA = 1e-6 * A
nA = 1e-9 * A

mbar = 1e-3 * bar
kPa = 1e3 * Pa
MPa = 1e6 * Pa

kOhm = 1e3 * Ohm
MOhm = 1e6 * Ohm

# Townsend (reduced electric field)
Td = 1e-17 * V / cm ** 2

electron_charge = electron_charge_SI * C
boltzmannConstant = boltzmannConstant_SI * J / K
