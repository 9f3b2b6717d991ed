"""chip_smoke.py's build report of the ssm_scan kernels, on text in the
formats that ``nvcc -Xptxas -v`` and ``cuobjdump -sass`` print: kernels
found by name, the hot loop as the backward branch around the most state
exponentials (not the softplus's, with its log, nor a loop with fewer),
the instruction mix and the FP32 pipe's share of it."""
import chip_smoke as cs
from _torch_threads import one_intra_op_thread  # noqa: F401

SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115ssm_scan_kernelIfLi16EEEvNS_6ParamsE
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
.L_x_3:
        /*0010*/                   MUFU.EX2 R4, R4 ;
        /*0018*/                   MUFU.EX2 R4, R4 ;
        /*0020*/                   MUFU.LG2 R5, R5 ;
        /*0030*/               @P1 BRA `(.L_x_3) ;
.L_x_7:
        /*0040*/                   FMUL R2, R3, R4 ;
        /*0048*/                   MUFU.EX2 R3, R3 ;
        /*0050*/                   FFMA.RM R6, R2, 12582913, R7 ;
        /*0060*/                   MUFU.EX2 R6, R6 ;
        /*0070*/                   FADD R8, R6, R9 ;
        /*0080*/                   SHFL.BFLY PT, R9, R8, 0x1, 0x1f ;
        /*0090*/              @!P0 BRA `(.L_x_7) ;
.L_x_9:
        /*00a0*/                   MUFU.EX2 R6, R6 ;
        /*00b0*/               @P2 BRA `(.L_x_9) ;
        /*00c0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_115ssm_step_kernelI13__nv_bfloat16Li16EEEvNS_6ParamsE
        /*0000*/                   MUFU.EX2 R4, R4 ;
        /*0010*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_113fa_fwd_kernelILi64EEEvv
        /*0000*/                   EXIT ;
"""

PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115ssm_scan_kernelIfLi16EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115ssm_scan_kernelIfLi16EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 14336 bytes smem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113fa_fwd_kernelILi64EEEvv' for 'sm_90a'
ptxas info    : Used 90 registers
"""


def test_sass_functions_hot_loop_and_mix():
    fns = cs._sass_functions(SASS, cs.SS_KERNEL_NAMES)
    assert sorted(fns) == ["ssm_scan_kernel<IfLi16>",
                           "ssm_step_kernel<I13__nv_bfloat16Li16>"]
    scan = fns["ssm_scan_kernel<IfLi16>"]
    assert scan["labels"] == {".L_x_3": 0x10, ".L_x_7": 0x40, ".L_x_9": 0xa0}
    loop = cs._hot_loop(scan)       # not the EX2 + LG2 loop, not 0xa0's
    assert [a for a, _ in loop] == [0x40, 0x48, 0x50, 0x60, 0x70, 0x80,
                                    0x90]
    mix = cs._sass_mix(loop)
    assert mix["fp32_pipe"] == 3 and mix["MUFU.EX2"] == 2
    assert mix["SHFL"] == 1 and mix["BRA"] == 1 and mix["total"] == 7
    assert cs._hot_loop(fns["ssm_step_kernel<I13__nv_bfloat16Li16>"]) == []


def test_ptxas_report_takes_the_names_asked_for():
    got = cs._ptxas_report(PTXAS, cs.SS_KERNEL_NAMES)
    assert got == {"ssm_scan_kernel<IfLi16>": {
        "spill_store_bytes": 0, "spill_load_bytes": 0, "registers": 40}}
    assert list(cs._ptxas_report(PTXAS)) == ["fa_fwd_kernel<ILi64>"]


FEDDPC_PTXAS = """ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119dequant_fold_kernelIaLb1EEEvPKT_PKfS5_PKliS5_S5_S5_S5_S5_fPfS8_ll' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111fold_kernelILb0EEEvPKfS2_S2_S2_S2_S2_fPfS3_ll' for 'sm_90a'
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115epilogue_kernelI13__nv_bfloat16EEvPKT_PKfS5_S5_PS2_l' for 'sm_90a'
ptxas info    : Used 24 registers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111dots_kernelILb1EEEvPKfS2_Pfll' for 'sm_90a'
ptxas info    : Used 32 registers
"""


def test_ptxas_report_names_the_feddpc_instances():
    """The longest kernel name that a mangled name holds wins (the
    dequant fold is not a fold_kernel), and a template of one type
    argument keeps it."""
    got = cs._ptxas_report(FEDDPC_PTXAS, cs.FEDDPC_KERNEL_NAMES)
    assert got == {
        "dequant_fold_kernel<IaLb1>": {"spill_store_bytes": 0,
                                       "spill_load_bytes": 0,
                                       "registers": 112},
        "fold_kernel<ILb0>": {"spill_store_bytes": 8, "spill_load_bytes": 4,
                              "registers": 40},
        "epilogue_kernel<I13__nv_bfloat16>": {"registers": 24},
        "dots_kernel<ILb1>": {"registers": 32}}
