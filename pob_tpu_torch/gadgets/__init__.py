"""Gadget library: tensor equivalents of the reference's circuits/utils/*
templates. Dynamic lengths are masked static-shape ops; every circom
assertion becomes a boolean "ok" flag that the circuit layer ANDs into a
validity bit."""
