"""chip_smoke.py names each kernel in ptxas's and cuobjdump's reports by
demangling it (`kernel_name`); the build gate fails on a kernel it cannot
name.  The kernels of `csrc/int4_matmul.cu` sit in an anonymous namespace,
whose mangled name carries a hex id that changes from build to build.
Plain Python: no card, no compiler."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

INT4 = "18int4_matmul_kernelILi128ELi2ELi4EEEv14CUtensorMapS1_PK6__half"


@pytest.mark.parametrize("mangled,want", [
    ("_Z16flash_fwd_kernelILi128EEvPK13__nv_bfloat16S2_S2_Pfi",
     "flash_fwd_kernel<128>"),
    ("_Z20flash_bwd_dkv_kernelILi256EEvPKfi", "flash_bwd_dkv_kernel<256>"),
    ("_Z19flash_bwd_dq_kernelILi64EEvv", "flash_bwd_dq_kernel<64>"),
    ("_Z12plain_kernelPf", "plain_kernel"),
    # the namespace's id ends in no digit
    ("_ZN37_GLOBAL__N__14_int4_matmul_cu_31530a44" + INT4,
     "int4_matmul_kernel<128,2,4>"),
    # ... and in digits ("47") that announce the 47 characters from the
    # file's id to the end of the kernel's name, which end in _kernel too
    ("_ZN40_GLOBAL__N__c1f2e047_14_int4_matmul_cu_31530a44" + INT4,
     "int4_matmul_kernel<128,2,4>"),
    ("_ZN40_GLOBAL__N__c1f2e047_14_int4_matmul_cu_31530a44"
     "18int4_matmul_kernelILi16ELi1ELi8EEEvv", "int4_matmul_kernel<16,1,8>"),
    ("_Z3foov", None),
])
def test_kernel_name_is_the_innermost_identifier(mangled, want):
    assert chip_smoke.kernel_name(mangled) == want
